"""Ashikhmin coherence search as a wrapper over a matcher (Hertzmann §3.2).

After the base matcher, Jacobi sweeps let each pixel consider its
neighbours' matches shifted by the relative offset (r* = s(r) + (q - r))
and adopt one when it beats the best coherent candidate so far and clears
the ceiling factor * d_approx.  Registered over the brute matcher, which
gives the reference's `--matcher brute --kappa K`.
"""

from __future__ import annotations

import torch

from ..config import SynthConfig
from .brute import BruteForceMatcher
from .matcher import (
    Matcher,
    candidate_dist,
    clamp_nnf,
    nnf_to_flat,
    register_matcher,
)
from .patchmatch import DELTAS, kappa_factor, shifted


def coherence_sweeps(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    dist: torch.Tensor,
    *,
    factor: float,
    sweeps: int,
) -> tuple:
    """Bias a match field toward coherent source regions; returns
    (nnf, dist)."""
    h, w, d = f_b.shape
    ha, wa = f_a.shape[:2]
    f_b_flat = f_b.reshape(-1, d)
    f_a_flat = f_a.reshape(-1, d)

    ceiling = dist * factor
    best_coh = torch.full_like(dist, float("inf"))
    for _ in range(sweeps):
        for dy, dx in DELTAS:
            cand = clamp_nnf(shifted(nnf, dy, dx), ha, wa)
            d_cand = candidate_dist(
                f_b_flat, f_a_flat, nnf_to_flat(cand, wa)
            ).reshape(h, w)
            accept = (d_cand < best_coh) & (d_cand <= ceiling)
            nnf = torch.where(accept[..., None], cand, nnf)
            dist = torch.where(accept, d_cand, dist)
            best_coh = torch.where(accept, d_cand, best_coh)
    return nnf, dist


class CoherenceWrapper(Matcher):
    """base matcher + kappa-biased coherence sweeps (no-op at kappa=0)."""

    def __init__(self, base: Matcher, sweeps: int = 2):
        self.base = base
        self.name = base.name
        self.sweeps = sweeps

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig, draws=None,
              raw=None, polish_iters=None):
        nnf, dist = self.base.match(
            f_b, f_a, nnf, level=level, cfg=cfg, draws=draws, raw=raw,
            polish_iters=polish_iters,
        )
        if cfg.kappa > 0.0:
            nnf, dist = coherence_sweeps(
                f_b, f_a, nnf, dist,
                factor=kappa_factor(cfg.kappa, level), sweeps=self.sweeps,
            )
        return nnf, dist


register_matcher("brute", CoherenceWrapper(BruteForceMatcher()))

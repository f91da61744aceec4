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
from .matcher import Matcher, candidate_dist, register_matcher
from .patchmatch import DELTAS, kappa_factor


def coherence_sweeps(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    dist: torch.Tensor,
    *,
    factor: float,
    sweeps: int,
) -> tuple:
    """`coherence_sweeps_lean` on the standard path's (H, W, D) feature
    fields and stacked (H, W, 2) field, with distances by
    `candidate_dist`; returns (nnf, dist)."""
    d = f_b.shape[-1]
    ha, wa = f_a.shape[:2]
    f_b_flat = f_b.reshape(-1, d)
    f_a_flat = f_a.reshape(-1, d)
    py, px, dist = coherence_sweeps_lean(
        nnf[..., 0], nnf[..., 1], dist, ha=ha, wa=wa, factor=factor,
        sweeps=sweeps,
        dist_fn=lambda idx: candidate_dist(f_b_flat, f_a_flat, idx),
    )
    return torch.stack([py, px], dim=-1), dist


def coherence_sweeps_lean(
    py: torch.Tensor,
    px: torch.Tensor,
    dist: torch.Tensor,
    *,
    ha: int,
    wa: int,
    factor: float,
    sweeps: int,
    dist_fn,
) -> tuple:
    """Bias a (py, px) plane-pair field toward coherent source regions,
    with distances through `dist_fn` (flat indices -> distances);
    returns (py, px, dist)."""
    ceiling = dist * factor
    best_coh = torch.full_like(dist, float("inf"))
    for _ in range(sweeps):
        for dy, dx in DELTAS:
            cy = (torch.roll(py, (dy, dx), (0, 1)) + dy).clamp(0, ha - 1)
            cx = (torch.roll(px, (dy, dx), (0, 1)) + dx).clamp(0, wa - 1)
            d_cand = dist_fn((cy * wa + cx).reshape(-1)).reshape(py.shape)
            accept = (d_cand < best_coh) & (d_cand <= ceiling)
            py = torch.where(accept, cy, py)
            px = torch.where(accept, cx, px)
            dist = torch.where(accept, d_cand, dist)
            best_coh = torch.where(accept, d_cand, best_coh)
    return py, px, dist


class CoherenceWrapper(Matcher):
    """base matcher + kappa-biased coherence sweeps (no-op at kappa=0)."""

    def __init__(self, base: Matcher, sweeps: int = 2):
        self.base = base
        self.name = base.name
        self.sweeps = sweeps

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig, draws=None,
              raw=None, polish_iters=None, temporal=None):
        nnf, dist = self.base.match(
            f_b, f_a, nnf, level=level, cfg=cfg, draws=draws, raw=raw,
            polish_iters=polish_iters, temporal=temporal,
        )
        if cfg.kappa > 0.0:
            nnf, dist = coherence_sweeps(
                f_b, f_a, nnf, dist,
                factor=kappa_factor(cfg.kappa, level), sweeps=self.sweeps,
            )
        return nnf, dist


register_matcher("brute", CoherenceWrapper(BruteForceMatcher()))

"""Brute-force exact nearest-neighbour matcher: the PSNR oracle.

    ||b - a||^2 = ||b||^2 - 2 b.a + ||a||^2

The argmin over A runs in kernel K2 on the card (kernels/nn_brute.py);
the winners' distances are then recomputed exactly (float32, direct
subtraction) so downstream accept tests see the same metric as
`candidate_dist`, free of the expansion's cancellation error.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SynthConfig
from ..kernels.nn_brute import nn_argmin
from .matcher import Matcher, candidate_dist, flat_to_nnf

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Rows per exact re-rank step (bounds the gathered-rows temp).
_RERANK_ROWS = 1 << 20


def exact_nn(
    f_b_flat: torch.Tensor,
    f_a_flat: torch.Tensor,
    chunk: int = 4096,
    match_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact argmin_p ||f_b[q] - f_a[p]||^2 for every query row; returns
    (idx (N,) int64, dist (N,) float32 recomputed exactly)."""
    idx = nn_argmin(f_b_flat, f_a_flat, chunk, match_dtype)
    dist = torch.cat([
        candidate_dist(
            f_b_flat[c : c + _RERANK_ROWS], f_a_flat,
            idx[c : c + _RERANK_ROWS],
        )
        for c in range(0, idx.shape[0], _RERANK_ROWS)
    ])
    return idx, dist


class BruteForceMatcher(Matcher):
    """Exact NN: kernel K2 on the card, the chunked matmul on the CPU."""

    name = "brute"

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig, draws=None,
              raw=None, polish_iters=None):
        h, w, d = f_b.shape
        wa = f_a.shape[1]
        idx, dist = exact_nn(
            f_b.reshape(-1, d),
            f_a.reshape(-1, d),
            chunk=min(cfg.brute_chunk, h * w),
            match_dtype=_DTYPES[cfg.match_dtype],
        )
        return flat_to_nnf(idx, wa, (h, w)), dist.reshape(h, w)

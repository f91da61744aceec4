"""`Matcher` interface, registry and the shared distance helpers.

A matcher maps feature fields to a nearest-neighbor field:

    match(f_b (H,W,D), f_a (Ha,Wa,D), nnf (H,W,2), *, level, cfg, ...)
        -> (nnf (H,W,2) int64, dist (H,W) float32)

where nnf[q] = (py, px) into A and dist[q] is the (weighted, squared) L2
feature distance of that correspondence.  Every matcher and the coherence
pass compute distances through `candidate_dist`, so they agree on the
metric exactly.

Fields are int64 in the port (PyTorch's index type); kernels take int32
and the wrappers convert at their boundary.
"""

from __future__ import annotations

from typing import Dict

import torch


def nnf_to_flat(nnf: torch.Tensor, wa: int) -> torch.Tensor:
    """(H, W, 2) (py, px) -> (H*W,) flat row-major indices into A."""
    return (nnf[..., 0] * wa + nnf[..., 1]).reshape(-1)


def flat_to_nnf(idx: torch.Tensor, wa: int, shape) -> torch.Tensor:
    """(H*W,) flat A indices -> (H, W, 2)."""
    idx = idx.long()
    return torch.stack([idx // wa, idx % wa], dim=-1).reshape(*shape, 2)


def clamp_nnf(nnf: torch.Tensor, ha: int, wa: int) -> torch.Tensor:
    return torch.stack(
        [nnf[..., 0].clamp(0, ha - 1), nnf[..., 1].clamp(0, wa - 1)], dim=-1
    )


def candidate_dist(
    f_b_flat: torch.Tensor, f_a_flat: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Distance between each query row and A-row `idx[q]`; (N,).

    The math runs in float32 whatever the table dtype (bf16 tables are
    gathered, then cast).  A-rows wider than the B side are sliced to the
    B width: the extra columns are zero pad and add nothing."""
    rows = f_a_flat.index_select(0, idx.reshape(-1))
    d = f_b_flat.shape[-1]
    if rows.shape[-1] != d:
        rows = rows[:, :d]
    diff = f_b_flat.float() - rows.float()
    return (diff * diff).sum(dim=-1)


def nnf_dist(
    f_b: torch.Tensor, f_a_flat: torch.Tensor, nnf: torch.Tensor, wa: int
) -> torch.Tensor:
    """Squared feature distance of each correspondence; (H, W)."""
    h, w, d = f_b.shape
    return candidate_dist(
        f_b.reshape(-1, d), f_a_flat, nnf_to_flat(nnf, wa)
    ).reshape(h, w)


class Matcher:
    """Base class: subclasses implement `match`."""

    name: str = "base"

    def match(self, f_b, f_a, nnf, *, level: int, cfg, draws=None,
              raw=None, polish_iters=None):
        """`draws` is the `SweepDraws` source of the random numbers a
        matcher consumes (None for exact search).  `raw` optionally
        carries the raw channel planes of the tile path
        (models.patchmatch.RawPlanes).  `polish_iters` overrides
        cfg.pm_polish_iters for this call (0 on non-final EM iterations
        when cfg.pm_polish_final_only)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


_REGISTRY: Dict[str, Matcher] = {}


def register_matcher(name: str, matcher: Matcher) -> None:
    _REGISTRY[name] = matcher


def get_matcher(name: str) -> Matcher:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown matcher {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None

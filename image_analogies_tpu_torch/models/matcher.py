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


def _take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab.index_select(0, idx)


def candidate_dist(
    f_b_flat: torch.Tensor, f_a_flat: torch.Tensor, idx: torch.Tensor,
    gather_fn=None,
) -> torch.Tensor:
    """Distance between each query row and A-row `idx[q]`; (N,).

    The math runs in float32 whatever the table dtype (bf16 tables are
    gathered, then cast).  A-rows wider than the B side are sliced to the
    B width: the extra columns are zero pad and add nothing.
    `gather_fn(table, flat_idx) -> rows` swaps the row fetch (the
    streamed polish's kernel K3, or the int8 polish's dequantizing
    fetch); the arithmetic after it is the same, so equal rows give
    bitwise-equal distances."""
    rows = (gather_fn or _take)(f_a_flat, idx.reshape(-1))
    d = f_b_flat.shape[-1]
    if rows.shape[-1] != d:
        rows = rows[:, :d]
    diff = f_b_flat.float() - rows.float()
    return (diff * diff).sum(dim=-1)


def candidate_dist_lean(
    f_b_tab: torch.Tensor, f_a_tab: torch.Tensor, idx: torch.Tensor,
    chunk: int = 1 << 20, gather_fn=None,
) -> torch.Tensor:
    """`candidate_dist` for indices with leading candidate axes: `idx`
    (..., N), query row i pairing with idx[..., i]; returns (..., N).
    Evaluated in query chunks of at most max(2^14, chunk // K) rows for
    K leading candidates, so the gathered-rows temp stays bounded.
    `gather_fn` swaps the row fetch as in `candidate_dist`.  The width
    comes from the B side: A rows wider than B (zero pad columns) are
    sliced back to B's width, which leaves every distance unchanged."""
    take = gather_fn or _take
    lead = idx.shape[:-1]
    n = idx.shape[-1]
    idx2 = idx.reshape(-1, n)
    k = idx2.shape[0]
    chunk = max(1 << 14, chunk // max(k, 1))
    d = f_b_tab.shape[1]
    if f_a_tab.shape[1] < d:
        raise ValueError(f"A table {tuple(f_a_tab.shape)} narrower than "
                         f"B table {tuple(f_b_tab.shape)}")
    outs = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        rows = take(f_a_tab, idx2[:, start:end].reshape(-1))
        a = rows[:, :d].float().reshape(k, end - start, d)
        diff = f_b_tab[start:end].float()[None] - a
        outs.append((diff * diff).sum(dim=-1))
    return torch.cat(outs, dim=1).reshape(*lead, n)


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
              raw=None, polish_iters=None, temporal=None):
        """`draws` is the `SweepDraws` source of the random numbers a
        matcher consumes (None for exact search).  `raw` optionally
        carries the raw channel planes of the tile path
        (models.patchmatch.RawPlanes).  `polish_iters` overrides
        cfg.pm_polish_iters for this call (0 on non-final EM iterations
        when cfg.pm_polish_final_only).  `temporal` optionally carries
        the previous video frame's converged (H, W, 2) field: with
        cfg.tau > 0 a matcher that honours it adds the temporal penalty
        (models.patchmatch.temporal_penalty_fn) to its candidate metric;
        the others ignore it."""
        raise NotImplementedError

    def match_frames(self, f_b, f_a, nnf, *, level: int, cfg, draws=None,
                     raw=None, polish_iters=None, temporal=None):
        """`match` over a leading frame axis of the B side, the level
        body's entry point (a single image is one frame): f_b
        (F, H, W, D), nnf (F, H, W, 2), `draws` one source a frame,
        `raw`'s B images and `temporal` (when given) stacked; A is
        shared.  Frame by frame here; a matcher that batches frames
        overrides it.  Returns the stacked (nnf, dist)."""
        from .patchmatch import _frames_of

        outs = [
            self.match(
                f_b[i], f_a, nnf[i], level=level, cfg=cfg,
                draws=None if draws is None else draws[i],
                raw=None if raw is None else _frames_of(raw, i),
                polish_iters=polish_iters,
                temporal=None if temporal is None else temporal[i],
            )
            for i in range(f_b.shape[0])
        ]
        return tuple(torch.stack(x) for x in zip(*outs))

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

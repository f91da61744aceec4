"""K4: one sweep of the per-pixel PatchMatch cascade in one launch.

A sweep of the cascade tries 4 propagation candidates, the 4 unshifted
neighbour matches and `n_random` random offsets, one after another, each
accepted by the same rule.  Run eagerly, a candidate is ~22 launches
(rolls, clamps, the index arithmetic, a gather, the distance, the
compares and three `where`s), so the 64^2 level and every tile level's
sequential polish were set by the host's issue of them.  The JAX package
runs the same cascade under `jit` (its `patchmatch_sweeps_lean`), where
XLA fuses it; no TPU kernel is replaced.

  - `cascade_sweep_kernel`: the CUDA kernel (`csrc/pixel_cascade.cu`),
    on float32 or bf16 (N, D) tables of CUDA tensors.  It computes the
    default table distance (`candidate_dist_lean`) in its own summation
    order: the same candidates and accept rule, distances within float32
    rounding of the plain version's, bit for bit where every sum is exact
    (integer-valued tables), and the same bits on every run.
  - `cascade_sweep_plain`: the cascade's eager loop body, on any
    `dist_fn`.
  - `cascade_sweeps`: the entry point the matcher calls, a sweep per
    offset tensor, which picks one of the two.

The kernel launches only where the default distance is asked for on a
CUDA table and the call is not `plain` (`pallas_mode="interpret"`).
Every other cascade keeps the plain version: the temporal term, the
"stream" polish through K3 and the int8 polish's dequantizing fetch (a
`gather`), the sharded runners' own `dist_fn`, and every CPU tensor.
So on the card bf16 "sequential" (this kernel) and "stream" (K3 and the
plain cascade) polishes agree within float32 rounding of each distance,
no longer bit for bit; on the CPU and under "interpret" both are the
plain cascade and stay bit-equal.  Under int8 candidates both polishes
fetch through the dequantizing gather, so both keep the plain cascade
and stay bit-equal on the card too (`chip_smoke.py`'s compressed phase
holds them so).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from ..telemetry.metrics import count_kernel_launch
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr

launches = LaunchCounter("pixel_cascade")

# Propagation neighbourhood: left, right, up, down (csrc/pixel_cascade.cu
# walks the same order).
DELTAS = ((0, -1), (0, 1), (-1, 0), (1, 0))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cascade_sweep_plain(
    py: torch.Tensor,
    px: torch.Tensor,
    dist: torch.Tensor,
    off: torch.Tensor,
    *,
    ha: int,
    wa: int,
    coh_factor: float,
    dist_fn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sweep on a clamped (py, px) field with its distances `dist`:
    the 4 propagation candidates, the 4 unshifted neighbour matches, then
    the (n_random, H, W, 2) offsets `off` added to the current match.
    Random candidates must satisfy d * coh_factor < d_cur; exact ties
    break toward the lower flat index.  `dist_fn` maps flat indices (N,)
    to distances (N,).  Returns (py, px, dist)."""
    h, w = py.shape

    def try_candidates(py, px, dist, cy, cx, factor):
        cy = cy.clamp(0, ha - 1)
        cx = cx.clamp(0, wa - 1)
        idx = cy * wa + cx
        d_cand = dist_fn(idx.reshape(-1)).reshape(h, w)
        accept = (d_cand * factor < dist) | (
            (d_cand == dist) & (idx < py * wa + px)
        )
        return (
            torch.where(accept, cy, py),
            torch.where(accept, cx, px),
            torch.where(accept, d_cand, dist),
        )

    for dy, dx in DELTAS:
        py, px, dist = try_candidates(
            py, px, dist, torch.roll(py, (dy, dx), (0, 1)) + dy,
            torch.roll(px, (dy, dx), (0, 1)) + dx, 1.0,
        )
    for dy, dx in DELTAS:
        py, px, dist = try_candidates(
            py, px, dist, torch.roll(py, (dy, dx), (0, 1)),
            torch.roll(px, (dy, dx), (0, 1)), 1.0,
        )
    off = off.to(py.device)
    for s in range(off.shape[0]):
        py, px, dist = try_candidates(
            py, px, dist, py + off[s, ..., 0], px + off[s, ..., 1],
            coh_factor,
        )
    return py, px, dist


def cascade_sweep_kernel(
    f_b_tab: torch.Tensor,
    f_a_tab: torch.Tensor,
    py: torch.Tensor,
    px: torch.Tensor,
    dist: Optional[torch.Tensor],
    off: torch.Tensor,
    *,
    ha: int,
    wa: int,
    coh_factor: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel: one sweep of `cascade_sweep_plain` under the
    default table distance, on contiguous CUDA tensors: (H W, D) B and
    (ha wa, D_a >= D) A tables of one dtype (float32 or bf16), int64
    (H, W) `py` / `px` (clamped to A in the kernel), float32 (H, W)
    `dist` or None (the kernel then computes the incoming match's
    distance first), int64 (n_random, H, W, 2) offsets.  Launches on the
    current stream; returns new (py, px, dist)."""
    h, w = py.shape if py.ndim == 2 else (-1, -1)
    if f_b_tab.dtype not in _DTYPES:
        raise ValueError(f"pixel_cascade: tables must be float32 or bf16, "
                         f"got {f_b_tab.dtype}")
    if f_b_tab.ndim != 2 or f_a_tab.ndim != 2:
        raise ValueError("pixel_cascade: tables must be 2-D (rows, width)")
    d, d_a = f_b_tab.shape[1], f_a_tab.shape[1]
    if d_a < d:
        raise ValueError(f"pixel_cascade: A rows of {d_a} are narrower than "
                         f"B rows of {d}")
    require(f_b_tab, f_b_tab.dtype, (h * w, d), "pixel_cascade B table")
    require(f_a_tab, f_b_tab.dtype, (ha * wa, d_a), "pixel_cascade A table")
    require(py, torch.int64, (h, w), "pixel_cascade py")
    require(px, torch.int64, (h, w), "pixel_cascade px")
    if dist is not None:
        require(dist, torch.float32, (h, w), "pixel_cascade dist")
    n_random = off.shape[0] if off.ndim == 4 else -1
    require(off, torch.int64, (n_random, h, w, 2), "pixel_cascade offsets")
    dev = f_b_tab.device
    if any(t.device != dev for t in (f_a_tab, py, px, off)) or (
            dist is not None and dist.device != dev):
        raise ValueError("pixel_cascade: tensors on different devices")
    py_out = torch.empty_like(py)
    px_out = torch.empty_like(px)
    dist_out = torch.empty((h, w), dtype=torch.float32, device=dev)
    scratch = torch.empty(6 * h * w, dtype=torch.int32, device=dev)
    err = library("pixel_cascade").ia_pixel_cascade(
        f_b_tab.data_ptr(), f_a_tab.data_ptr(), _DTYPES[f_b_tab.dtype], d,
        d, d_a, h, w, ha, wa, py.data_ptr(), px.data_ptr(),
        None if dist is None else dist.data_ptr(), off.data_ptr(), n_random,
        float(coh_factor), scratch.data_ptr(), py_out.data_ptr(),
        px_out.data_ptr(), dist_out.data_ptr(), stream_ptr(py),
    )
    check(err, "ia_pixel_cascade")
    launches.add()
    count_kernel_launch("pixel_cascade")
    return py_out, px_out, dist_out


def cascade_sweeps(
    f_b_tab: torch.Tensor,
    f_a_tab: torch.Tensor,
    py: torch.Tensor,
    px: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    ha: int,
    wa: int,
    coh_factor: float,
    dist_fn=None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One propagate + random-search sweep per entry of `offsets` (each
    (n_random, H, W, 2), added to the current match) over (N, D) tables
    and a (py, px) plane-pair field; returns (py, px, dist).  Random
    candidates must satisfy d * coh_factor < d_cur; exact ties break
    toward the lower flat index, the representative the brute oracle's
    argmin picks.  Distances go through `dist_fn` (flat indices ->
    distances), by default `candidate_dist_lean` on the tables.

    With the default distance on CUDA tables and not `plain`, every
    sweep is one launch of the kernel; otherwise each runs
    `cascade_sweep_plain`."""
    h, w = py.shape
    if dist_fn is None and on_cuda(f_a_tab) and not plain:
        f_b_tab, f_a_tab = f_b_tab.contiguous(), f_a_tab.contiguous()
        py = py.long().contiguous()
        px = px.long().contiguous()
        dist = None
        for off in offsets:
            py, px, dist = cascade_sweep_kernel(
                f_b_tab, f_a_tab, py, px, dist, off.contiguous(), ha=ha,
                wa=wa, coh_factor=coh_factor,
            )
        if dist is not None:
            return py, px, dist
    if dist_fn is None:
        from ..models.matcher import candidate_dist_lean

        def dist_fn(idx):
            return candidate_dist_lean(f_b_tab, f_a_tab, idx)

    py = py.long().clamp(0, ha - 1)
    px = px.long().clamp(0, wa - 1)
    dist = dist_fn((py * wa + px).reshape(-1)).reshape(h, w)
    for off in offsets:
        py, px, dist = cascade_sweep_plain(
            py, px, dist, off, ha=ha, wa=wa, coh_factor=coh_factor,
            dist_fn=dist_fn,
        )
    return py, px, dist

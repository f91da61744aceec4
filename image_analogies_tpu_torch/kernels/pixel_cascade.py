"""K4: one sweep of the per-pixel PatchMatch cascade in one launch.

A sweep of the cascade (`models/patchmatch.py` `patchmatch_sweeps_lean`)
tries 4 propagation candidates, the 4 unshifted neighbour matches and
`n_random` random offsets, one after another, each accepted by the same
rule.  Run eagerly, a candidate is ~22 launches (rolls, clamps, the index
arithmetic, a gather, the distance, the compares and three `where`s), so
the 64^2 level and every tile level's sequential polish were set by the
host's issue of them.  The JAX package runs the same cascade under
`jit`, where XLA fuses it; no TPU kernel is replaced.

  - `cascade_sweep_kernel`: the CUDA kernel (`csrc/pixel_cascade.cu`),
    on float32 or bf16 (N, D) tables of CUDA tensors.  It computes the
    default table distance (`candidate_dist_lean`) in its own summation
    order: the same candidates and accept rule, distances within float32
    rounding of the plain version's, bit for bit where every sum is exact
    (integer-valued tables), and the same bits on every run.
  - `cascade_sweep_plain`: the cascade's eager loop body, on any
    `dist_fn`.
  - `sweep_engine`: the dispatch rule the cascade's callers share.

The kernel launches only where the default distance is asked for on a
CUDA table and the call is not `plain` (`pallas_mode="interpret"`).
Every other cascade keeps the plain version: the temporal term, the
"stream" polish through K3 and the int8 polish's dequantizing fetch (a
`gather`), the sharded runners' own `dist_fn`, and every CPU tensor.  An
eager sweep on CUDA tensors is counted with its reason
(`ia_eager_sweeps_total{reason}`).  So on the card bf16 "sequential"
(this kernel) and "stream" (K3 and the plain cascade) polishes agree
within float32 rounding of each distance, no longer bit for bit; on the
CPU and under "interpret" both are the plain cascade and stay bit-equal.
Under int8 candidates both polishes fetch through the dequantizing
gather, so both keep the plain cascade and stay bit-equal on the card
too (`chip_smoke.py`'s compressed phase holds them so).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..telemetry.metrics import count_eager_sweep, count_kernel_launch
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr

launches = LaunchCounter("pixel_cascade")

# Propagation neighbourhood: left, right, up, down (csrc/pixel_cascade.cu
# walks the same order).
DELTAS = ((0, -1), (0, 1), (-1, 0), (1, 0))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sweep_engine(tab: torch.Tensor, *, plain: bool, default_dist: bool) -> str:
    """"k4" where a cascade over table `tab` launches the kernel: a CUDA
    table, not `plain`, the default table distance; else "eager"."""
    return "k4" if on_cuda(tab) and not plain and default_dist else "eager"


def count_eager(tab: torch.Tensor, reason: str) -> None:
    """Book one eager sweep over CUDA table `tab` by `reason` ("plain",
    "temporal", "gather", "dist_fn"); CPU sweeps are not booked."""
    if on_cuda(tab):
        count_eager_sweep(reason)


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

"""K3: the candidate-row gather of the streamed polish, and its tables.

The "stream" polish engine (models/patchmatch.py) is the sequential
polish with its candidate-row fetches routed through this gather instead
of `index_select`; the int8 polish fetches per-patch-quantized rows
(`quantize_rows`) through it.  The kernel is pure data movement, so the
distances computed from its rows are bitwise those of the `index_select`
path: rows wider than the B side are sliced back before the float32 math
(models/matcher.py `candidate_dist`).

  - `gather_rows_kernel`: the CUDA kernel (`csrc/row_gather.cu`), for CUDA
    tensors.  Replaces the Pallas kernel `_make_gather_kernel` of
    image_analogies_tpu/kernels/polish_stream.py.
  - `gather_rows_plain`: clamp the indices, then `index_select`.
  - `gather_rows`: the dispatch by device, plus `plain` for
    `pallas_mode="interpret"`.

The kernel path books the fetched rows and their bytes
(`polish_dma_bytes_per_fetch`, the row K3 copies) in the telemetry
ledger the run sentinel prices; the plain path books nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..telemetry.metrics import (
    count_polish_dma_bytes,
    count_polish_dma_rows,
    get_registry,
)
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr

LANE = 128

launches = LaunchCounter("gather_rows")

# Bytes of the per-patch float32 scale an int8 row fetch dequantizes with.
_SCALE_BYTES = 4


def prepare_polish_table(f_a_tab: torch.Tensor) -> torch.Tensor:
    """(Na, D <= LANE) table -> a contiguous (Na, LANE) copy zero-padded on
    the right; a table already LANE wide is returned as it is."""
    d = f_a_tab.shape[1]
    if d == LANE:
        return f_a_tab
    if d > LANE:
        raise ValueError(f"feature width {d} > {LANE} lanes")
    return F.pad(f_a_tab, (0, LANE - d)).contiguous()


def polish_dma_bytes_per_fetch(d_useful: int, itemsize: int = 2,
                               cand_dtype: str = "bf16") -> Tuple[int, int]:
    """(moved, useful) bytes of one candidate-row fetch: the LANE-padded
    row (next 128-lane multiple past LANE) and the unpadded width, both
    plus the float32 scale under "int8".  For a width up to LANE, `moved`
    is what `csrc/row_gather.cu` copies a row: the whole (Na, LANE) row of
    `prepare_polish_table`, LANE x itemsize bytes in 16-byte chunks (256
    bytes bf16, 128 int8)."""
    if d_useful <= 0:
        raise ValueError(f"d_useful {d_useful} must be positive")
    scale = _SCALE_BYTES if cand_dtype == "int8" else 0
    lanes = -(-d_useful // LANE) * LANE
    return lanes * itemsize + scale, d_useful * itemsize + scale


def quantize_rows(tab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) table -> ((N, D) int8, (N, 1) float32 per-row scales):
    q = round(x / s), s = max|row| / 127 (at least 1e-12 / 127)."""
    x = tab.float()
    s = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12) \
        * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)
    return q, s


def polish_eval_rows(n_queries: int, iters: int, n_random: int) -> int:
    """Candidate-row evaluations of one sequential (or streamed) polish
    call: the entry evaluation, then per sweep 4 shifted + 4 unshifted
    propagation candidates and `n_random` probes."""
    return n_queries * (1 + iters * (8 + n_random))


def _check_table(table: torch.Tensor) -> None:
    if table.ndim != 2 or table.shape[1] != LANE:
        raise ValueError(
            f"table must be LANE-padded (got {tuple(table.shape)}); run "
            "prepare_polish_table first"
        )


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (any shape, flattened), clamped to [0, Na - 1], of the
    (Na, LANE) table: (idx.numel(), LANE) in the table's dtype."""
    _check_table(table)
    flat = idx.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat)


def book_polish_rows(m: int, d_useful: int, itemsize: int,
                     cand_dtype: str) -> None:
    """Book `m` polish row fetches, their bytes and rows as one unit."""
    moved, useful = polish_dma_bytes_per_fetch(d_useful, itemsize,
                                               cand_dtype)
    with get_registry().unit():
        count_polish_dma_bytes(useful=m * useful, padded=m * (moved - useful),
                               dtype=cand_dtype)
        count_polish_dma_rows(m, d_useful, itemsize, cand_dtype)


def gather_rows_kernel(table: torch.Tensor, idx: torch.Tensor, *,
                       useful_width: Optional[int] = None,
                       cand_dtype: str = "bf16") -> torch.Tensor:
    """The CUDA kernel on a contiguous (Na, LANE) CUDA table of any
    1-, 2- or 4-byte dtype and CUDA indices; same contract as
    `gather_rows_plain`.  Launches on the current stream, and books the
    launch's rows in the polish ledger (`book_polish_rows`), priced at
    `useful_width` (the unpadded feature width; default LANE) and
    `cand_dtype` ("int8": the caller gathers the per-row scales beside
    these rows, so the pricing adds them)."""
    _check_table(table)
    require(table, table.dtype, table.shape, "gather_rows table")
    flat = idx.reshape(-1).long().contiguous()
    if flat.device != table.device:
        raise ValueError("gather_rows: tensors on different devices")
    if table.data_ptr() % 16:
        raise ValueError("gather_rows: table must be 16-byte aligned")
    m = flat.numel()
    out = torch.empty((m, LANE), dtype=table.dtype, device=table.device)
    if m == 0:
        return out
    err = library("row_gather").ia_gather_rows(
        table.data_ptr(), flat.data_ptr(), out.data_ptr(), m,
        table.shape[0], LANE * table.element_size(), stream_ptr(table),
    )
    check(err, "ia_gather_rows")
    launches.add()
    book_polish_rows(m, useful_width or LANE, table.element_size(),
                     cand_dtype)
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                plain: bool = False, useful_width: Optional[int] = None,
                cand_dtype: str = "bf16") -> torch.Tensor:
    """Row gather: the kernel for CUDA tensors, the plain version for CPU
    tensors, or the plain version on either device when `plain` (the
    explicit `pallas_mode="interpret"`).  `useful_width` and
    `cand_dtype` price the kernel's ledger (`gather_rows_kernel`)."""
    if on_cuda(table) and not plain:
        return gather_rows_kernel(table, idx, useful_width=useful_width,
                                  cand_dtype=cand_dtype)
    return gather_rows_plain(table, idx)

"""K2: exact nearest neighbour over a feature table.

For each query row b: the argmin over A rows of ||a||^2 - 2 b.a (the
||b||^2 term is constant per row and cannot move the argmin), accumulated
in float32, the lowest index winning ties as `jnp.argmin` does.  The
N_B x N_A matrix is never materialized.

  - `nn_argmin_kernel`: the hand-written CUDA kernel (`csrc/nn_brute.cu`),
    for float32 or bfloat16 CUDA tensors, on the tensor cores.  Replaces
    the Pallas kernel `_make_nn_kernel` of
    image_analogies_tpu/kernels/nn_brute.py.  bfloat16 rows multiply
    exactly in float32; float32 rows are split into two TF32 parts and
    multiplied in three passes (`split_tf32`).
  - `nn_argmin_plain`: the plain PyTorch version, a chunked float32
    `torch.matmul` plus `argmin`, for CPU tensors and as the kernel's
    yardstick on the card; with `tf32_passes=3` it repeats the kernel's
    float32 arithmetic (TF32 rounding emulated on the float32 bits).
  - `nn_argmin`: the dispatch by device.

The exact float32 re-rank of the winners lives with the matcher
(models/brute.py `exact_nn`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..telemetry.metrics import count_kernel_launch
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr
from ..ops.pca import full_f32_matmul

launches = LaunchCounter("nn_argmin")

# The kernel's tiles: A rows are padded to ROW_TILE (rows per tile),
# queries to QUERY_TILE (the most a block holds), the feature width to
# the MMA depth of the row type
# (8 TF32 or 16 bfloat16 columns), up to the widest table whose query
# tile still fits a block's shared memory.
ROW_TILE = 128
QUERY_TILE = 256
_K_STEP = {torch.float32: 8, torch.bfloat16: 16}
_MAX_D_PAD = {torch.float32: 256, torch.bfloat16: 384}


def padded_dim(d: int, dtype: torch.dtype) -> int:
    """The feature width the kernel works on: `d` rounded up to the MMA
    depth of `dtype`; the pad columns are zeros."""
    k = _K_STEP[dtype]
    return -(-d // k) * k


def squared_norms(f_a: torch.Tensor) -> torch.Tensor:
    """||a||^2 per A row, in float32."""
    fa = f_a.float()
    return (fa * fa).sum(dim=-1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties
    away from zero, as `cvt.rna.tf32.f32`), returned as float32: add half
    a TF32 ulp to the magnitude bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo + (a residual below 2^-21 |x|) with both parts TF32
    values: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def nn_argmin_plain(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    a_sq: torch.Tensor,
    chunk: int = 4096,
    match_dtype: torch.dtype = torch.float32,
    tf32_passes: int = 0,
) -> torch.Tensor:
    """Chunked matmul + argmin; (N_B,) int64.  Inputs are cast to
    `match_dtype` and their products accumulated in float32.
    `tf32_passes` chooses the float32 rows' product: 0 a float32 matmul;
    3 the kernel's compensated TF32 route, b_hi.a_lo + b_lo.a_hi +
    b_hi.a_hi on the split rows, small terms first."""
    if tf32_passes not in (0, 3):
        raise ValueError(f"tf32_passes {tf32_passes} is neither 0 nor 3")
    fa = f_a.to(match_dtype).float()
    if tf32_passes:
        a_hi, a_lo = split_tf32(fa)
    out = []
    with full_f32_matmul():
        for c in range(0, f_b.shape[0], chunk):
            fb = f_b[c : c + chunk].to(match_dtype).float()
            if tf32_passes:
                b_hi, b_lo = split_tf32(fb)
                dot = (b_hi @ a_lo.T + b_lo @ a_hi.T) + b_hi @ a_hi.T
            else:
                dot = fb @ fa.T
            d = a_sq[None, :] - 2.0 * dot
            out.append(torch.argmin(d, dim=-1))
    if not out:
        return torch.zeros(0, dtype=torch.long, device=f_b.device)
    return torch.cat(out)


def nn_argmin_kernel(
    f_b: torch.Tensor, f_a: torch.Tensor, a_sq: torch.Tensor
) -> torch.Tensor:
    """The CUDA kernel on (N_B, D) / (N_A, D) CUDA tensors, both float32
    (three compensated TF32 passes) or both bfloat16 (exact products),
    with float32 `a_sq`; (N_B,) int64.  A pre-pass pads the rows to
    `QUERY_TILE` / `ROW_TILE`, the width to `padded_dim`, scales A by -2,
    splits float32 tables into TF32 parts, and writes the kernel's tiled
    layout."""
    n_b, d = f_b.shape
    n_a = f_a.shape[0]
    dt = f_b.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"nn_argmin: expected float32 or bfloat16, got {dt}")
    require(f_b, dt, (n_b, d), "nn_argmin f_b")
    require(f_a, dt, (n_a, d), "nn_argmin f_a")
    require(a_sq, torch.float32, (n_a,), "nn_argmin a_sq")
    if f_a.device != f_b.device or a_sq.device != f_b.device:
        raise ValueError("nn_argmin: tensors on different devices")
    if n_a < 1 or d < 1:
        raise ValueError(f"nn_argmin: empty A table {tuple(f_a.shape)}")
    d_pad = padded_dim(d, dt)
    if d_pad > _MAX_D_PAD[dt]:
        raise ValueError(
            f"nn_argmin: width {d} pads to {d_pad}, past the kernel's "
            f"{_MAX_D_PAD[dt]} for {dt}")
    dev = f_b.device
    idx = torch.empty(n_b, dtype=torch.int32, device=dev)
    if n_b == 0:
        return idx.long()
    dist = torch.empty(n_b, dtype=torch.float32, device=dev)
    n_b_pad = -(-n_b // QUERY_TILE) * QUERY_TILE
    n_a_pad = -(-n_a // ROW_TILE) * ROW_TILE
    # Padded A rows score +inf and never win the strict `<`.
    sq_pad = F.pad(a_sq, (0, n_a_pad - n_a), value=float("inf"))
    lib = library("nn_brute")
    stream = stream_ptr(f_b)

    def table(n_pad):
        return torch.empty((n_pad, d_pad), dtype=dt, device=dev)

    if dt == torch.float32:
        b_hi, b_lo = table(n_b_pad), table(n_b_pad)
        a_hi, a_lo = table(n_a_pad), table(n_a_pad)
        check(lib.ia_nn_split_tf32(
            f_b.data_ptr(), n_b, d, n_b_pad, d_pad, 1.0, b_hi.data_ptr(),
            b_lo.data_ptr(), stream), "ia_nn_split_tf32")
        check(lib.ia_nn_split_tf32(
            f_a.data_ptr(), n_a, d, n_a_pad, d_pad, -2.0, a_hi.data_ptr(),
            a_lo.data_ptr(), stream), "ia_nn_split_tf32")
        for t, n_pad in ((b_hi, n_b_pad), (b_lo, n_b_pad), (a_hi, n_a_pad),
                         (a_lo, n_a_pad)):
            require(t, dt, (n_pad, d_pad), "nn_argmin padded table")
        err = lib.ia_nn_argmin(
            b_hi.data_ptr(), b_lo.data_ptr(), a_hi.data_ptr(),
            a_lo.data_ptr(), sq_pad.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), n_b, n_b_pad, n_a_pad, d_pad, stream)
        check(err, "ia_nn_argmin")
    else:
        b_pad, a_pad = table(n_b_pad), table(n_a_pad)
        check(lib.ia_nn_pad_bf16(
            f_b.data_ptr(), n_b, d, n_b_pad, d_pad, 1.0, b_pad.data_ptr(),
            stream), "ia_nn_pad_bf16")
        check(lib.ia_nn_pad_bf16(
            f_a.data_ptr(), n_a, d, n_a_pad, d_pad, -2.0, a_pad.data_ptr(),
            stream), "ia_nn_pad_bf16")
        for t, n_pad in ((b_pad, n_b_pad), (a_pad, n_a_pad)):
            require(t, dt, (n_pad, d_pad), "nn_argmin padded table")
        err = lib.ia_nn_argmin_bf16(
            b_pad.data_ptr(), a_pad.data_ptr(), sq_pad.data_ptr(),
            idx.data_ptr(), dist.data_ptr(), n_b, n_b_pad, n_a_pad, d_pad,
            stream)
        check(err, "ia_nn_argmin_bf16")
    launches.add()
    count_kernel_launch("exact_nn")
    # Match fields are int64 in the port (models/matcher.py).
    return idx.long()


def argmin_metric(f_b, f_a, a_sq, idx, match_dtype=torch.float32):
    """The quantity the argmin minimizes, ||b~||^2 + ||a||^2 - 2 b~.a~
    (rows rounded to `match_dtype`, `a_sq` of the unrounded rows), for
    rows `idx`, in float64: for holding two argmins' picks against each
    other up to ties."""
    fb = f_b.to(match_dtype).double()
    fa = f_a.to(match_dtype).double().index_select(0, idx)
    return (fb * fb).sum(-1) + a_sq.double().index_select(0, idx) \
        - 2.0 * (fb * fa).sum(-1)


def nn_argmin(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    chunk: int = 4096,
    match_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Exact-NN argmin: the kernel for CUDA tensors, the plain version for
    CPU tensors.  Both cast the rows to `match_dtype` (float32 or
    bfloat16); `a_sq` is the float32 norms of the unrounded A rows.  On
    the CPU float32 rows multiply in a float32 matmul, not in the
    kernel's three TF32 passes (`nn_argmin_plain(tf32_passes=3)`): the
    two agree except at near-ties, but a flipped near-tie early in an EM
    run moves later distances, and the CPU path is held against the
    reference package bit for bit there."""
    a_sq = squared_norms(f_a)
    if on_cuda(f_b):
        return nn_argmin_kernel(
            f_b.to(match_dtype).contiguous(),
            f_a.to(match_dtype).contiguous(), a_sq,
        )
    return nn_argmin_plain(f_b, f_a, a_sq, chunk, match_dtype)

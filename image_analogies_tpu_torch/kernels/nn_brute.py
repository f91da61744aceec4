"""K2: exact nearest neighbour over a feature table.

For each query row b: the argmin over A rows of ||a||^2 - 2 b.a (the
||b||^2 term is constant per row and cannot move the argmin), accumulated
in float32, the lowest index winning ties as `jnp.argmin` does.  The
N_B x N_A matrix is never materialized.

  - `nn_argmin_kernel`: the hand-written CUDA kernel (`csrc/nn_brute.cu`),
    for float32 or bfloat16 CUDA tensors.  Replaces the Pallas kernel
    `_make_nn_kernel` of image_analogies_tpu/kernels/nn_brute.py.
  - `nn_argmin_plain`: the plain PyTorch version, a chunked float32
    `torch.matmul` plus `argmin`, for CPU tensors and as the kernel's
    yardstick on the card.
  - `nn_argmin`: the dispatch by device.

The exact float32 re-rank of the winners lives with the matcher
(models/brute.py `exact_nn`).
"""

from __future__ import annotations

import torch

from . import LaunchCounter, check, library, on_cuda, require, stream_ptr
from ..ops.pca import full_f32_matmul

launches = LaunchCounter("nn_argmin")


def squared_norms(f_a: torch.Tensor) -> torch.Tensor:
    """||a||^2 per A row, in float32."""
    fa = f_a.float()
    return (fa * fa).sum(dim=-1)


def nn_argmin_plain(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    a_sq: torch.Tensor,
    chunk: int = 4096,
    match_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Chunked matmul + argmin; (N_B,) int64.  Inputs are cast to
    `match_dtype` and their products accumulated in float32."""
    fa = f_a.to(match_dtype).float()
    out = []
    with full_f32_matmul():
        for c in range(0, f_b.shape[0], chunk):
            fb = f_b[c : c + chunk].to(match_dtype).float()
            d = a_sq[None, :] - 2.0 * (fb @ fa.T)
            out.append(torch.argmin(d, dim=-1))
    if not out:
        return torch.zeros(0, dtype=torch.long, device=f_b.device)
    return torch.cat(out)


def nn_argmin_kernel(
    f_b: torch.Tensor, f_a: torch.Tensor, a_sq: torch.Tensor
) -> torch.Tensor:
    """The CUDA kernel on (N_B, D) / (N_A, D) CUDA tensors, both float32
    or both bfloat16 (widened to float32 in the kernel), with float32
    `a_sq`; (N_B,) int64."""
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
    idx = torch.empty(n_b, dtype=torch.int32, device=f_b.device)
    dist = torch.empty(n_b, dtype=torch.float32, device=f_b.device)
    entry = "ia_nn_argmin_bf16" if dt == torch.bfloat16 else "ia_nn_argmin"
    err = getattr(library("nn_brute"), entry)(
        f_b.data_ptr(), f_a.data_ptr(), a_sq.data_ptr(), idx.data_ptr(),
        dist.data_ptr(), n_b, n_a, d, stream_ptr(f_b),
    )
    check(err, entry)
    launches.add()
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
    bfloat16); `a_sq` is the float32 norms of the unrounded A rows."""
    a_sq = squared_norms(f_a)
    if on_cuda(f_b):
        return nn_argmin_kernel(
            f_b.to(match_dtype).contiguous(),
            f_a.to(match_dtype).contiguous(), a_sq,
        )
    return nn_argmin_plain(f_b, f_a, a_sq, chunk, match_dtype)

"""PCA projection of feature vectors (Hertzmann §3.1).

The basis is fit per level on the A-side features (the search database)
and applied to both sides.  Matching compares feature differences, and an
orthonormal projection of a difference does not depend on centering, so
the basis is fit on centered data but raw features are projected.
Products run in full float32 (no TF32) on every device.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32: a caller may have
    enabled TF32, which keeps only ~3 decimal digits."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _f32_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():
        return x @ y


def pca_basis(x_flat: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k principal directions of (N, D) rows; returns (D, k), columns
    orthonormal and ordered by decreasing eigenvalue.  `k` is clamped to
    D.  Each column's sign is arbitrary, as in any eigendecomposition."""
    n, d = x_flat.shape
    k = min(k, d)
    x = x_flat.float()
    xc = x - x.mean(dim=0, keepdim=True)
    cov = _f32_matmul(xc.T, xc) / max(n - 1, 1)
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    return vecs.flip(-1)[:, :k].contiguous()


def project(f: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(..., D) features -> (..., k) in the PCA basis."""
    lead = f.shape[:-1]
    out = _f32_matmul(f.reshape(-1, f.shape[-1]).float(), basis)
    return out.reshape(*lead, basis.shape[-1])


def fit_and_project(f_a: torch.Tensor, k) -> tuple:
    """Per-level A-side PCA: (f_a_projected, basis), or (f_a, None) when
    `k` is falsy."""
    if not k:
        return f_a, None
    basis = pca_basis(f_a.reshape(-1, f_a.shape[-1]), k)
    return project(f_a, basis), basis

"""Steerable-filter feature bank (Hertzmann §3.1; config 4).

Oriented first-derivative-of-Gaussian responses, all orientations in one
`conv2d` over the edge-padded luminance.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .pyramid import full_f32_conv


def _dog_bank(n_orientations: int, size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """(n_orient, 1, size, size) bank G_theta = cos(theta) Gx + sin(theta) Gy."""
    r = size // 2
    y, x = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    g = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    gx = -x / sigma**2 * g
    gy = -y / sigma**2 * g
    norm = np.sqrt((gx**2).sum())
    gx, gy = gx / norm, gy / norm
    filters = []
    for i in range(n_orientations):
        theta = np.pi * i / n_orientations
        filters.append(np.cos(theta) * gx + np.sin(theta) * gy)
    return np.stack(filters)[:, None]


def steerable_responses(
    y: torch.Tensor, n_orientations: int = 4, size: int = 5
) -> torch.Tensor:
    """(H, W) luminance -> (H, W, n_orientations) oriented responses."""
    bank = torch.as_tensor(
        _dog_bank(n_orientations, size=size), dtype=y.dtype, device=y.device
    )
    r = size // 2
    x = F.pad(y[None, None], (r, r, r, r), mode="replicate")
    with full_f32_conv():
        out = F.conv2d(x, bank)
    return out[0].permute(1, 2, 0).contiguous()

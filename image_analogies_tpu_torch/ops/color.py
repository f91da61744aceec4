"""Color-space ops: RGB <-> YIQ (Hertzmann §3.4 luminance-only matching).

The 3x3 transforms are written as three multiply-adds per output channel
instead of a matmul, so the result is full float32 on every device (a
CUDA matmul may run in TF32 when a caller enables it).

Images are float tensors in [0, 1], (H, W, 3) color or (H, W) luminance.
"""

from __future__ import annotations

import numpy as np
import torch

_RGB2YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.595716, -0.274453, -0.321263],
        [0.211456, -0.522591, 0.311135],
    ],
    dtype=np.float64,
)
# The exact inverse (not the truncated textbook constants), so the round
# trip is lossless to float32 precision.
_YIQ2RGB = np.linalg.inv(_RGB2YIQ)


def _apply3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    m = m.astype(np.float32)
    rows = [
        x[..., 0] * float(r[0]) + x[..., 1] * float(r[1])
        + x[..., 2] * float(r[2])
        for r in m
    ]
    return torch.stack(rows, dim=-1)


def rgb_to_yiq(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0,1] -> (..., 3) YIQ."""
    return _apply3(rgb, _RGB2YIQ)


def yiq_to_rgb(yiq: torch.Tensor) -> torch.Tensor:
    """(..., 3) YIQ -> (..., 3) RGB (not clipped)."""
    return _apply3(yiq, _YIQ2RGB)


def luminance(img: torch.Tensor) -> torch.Tensor:
    """Y channel of an (H, W, 3) RGB image, or the image itself if 2D."""
    if img.ndim == 2:
        return img
    r = _RGB2YIQ[0].astype(np.float32)
    return (
        img[..., 0] * float(r[0]) + img[..., 1] * float(r[1])
        + img[..., 2] * float(r[2])
    )

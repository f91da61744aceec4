"""Quality metrics — PSNR is the acceptance currency (B' against the
brute-force oracle's B')."""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def psnr(x, y, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two [0,peak] images
    (tensors on any device, or arrays)."""
    mse = float(np.mean((_np(x) - _np(y)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)

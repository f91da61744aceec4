"""Gaussian pyramids.

Conventions (as the reference):
  - level 0 is the finest level; level L-1 the coarsest;
  - images are (H, W) or (H, W, C) float32;
  - downsampling is blur + stride-2; upsampling is a bilinear resize.

The blur is an edge pad (`replicate`) followed by a depthwise `conv2d`
with the 5-tap binomial, vertical pass then horizontal pass.  Convolutions
run with cuDNN's TF32 off, so the pyramid is float32 on every device.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

# 5-tap binomial approximation to a Gaussian (Burt & Adelson kernel).
_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@contextlib.contextmanager
def full_f32_conv():
    """Run convolutions in full float32: cuDNN's TF32 default would keep
    only ~3 decimal digits."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def to_nchw(img: torch.Tensor):
    """(H,W) or (H,W,C) -> (1, C, H, W), remembering the original rank."""
    if img.ndim == 2:
        return img[None, None], True
    return img.permute(2, 0, 1)[None], False


def from_nchw(x: torch.Tensor, was_2d: bool) -> torch.Tensor:
    if was_2d:
        return x[0, 0]
    return x[0].permute(1, 2, 0).contiguous()


def _sep_conv(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Depthwise separable 2D convolution of (1,C,H,W), edge-padded."""
    c = x.shape[1]
    r = k1d.shape[0] // 2
    k = torch.as_tensor(k1d, dtype=x.dtype, device=x.device)
    kv = k.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1)
    kh = k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1)
    x = F.pad(x, (r, r, r, r), mode="replicate")
    with full_f32_conv():
        x = F.conv2d(x, kv, groups=c)
        x = F.conv2d(x, kh, groups=c)
    return x


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """Binomial 5x5 Gaussian blur, edge-padded, any (H,W[,C]) image."""
    x, was_2d = to_nchw(img)
    return from_nchw(_sep_conv(x, _KERNEL_1D), was_2d)


def downsample(img: torch.Tensor) -> torch.Tensor:
    """Blur + stride-2 subsample (pyrDown)."""
    return gaussian_blur(img)[::2, ::2].contiguous()


def upsample(img: torch.Tensor, target_shape) -> torch.Tensor:
    """Bilinear resize to `target_shape` (H, W).  Half-pixel centers with
    edge clamping (`align_corners=False`) equal `jax.image.resize(...,
    "bilinear")` for every upscale, odd target sizes included: JAX drops
    out-of-image taps and renormalizes, which puts the full weight on the
    edge pixel exactly as the clamp does."""
    x, was_2d = to_nchw(img)
    y = F.interpolate(
        x, size=tuple(int(s) for s in target_shape), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return from_nchw(y, was_2d)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[level0 (finest), ..., level_{L-1} (coarsest)]."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample(pyr[-1]))
    return pyr

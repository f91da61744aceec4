"""Feature-vector assembly (Hertzmann §3.1).

Per pixel q at level l the feature vector concatenates a `patch` x `patch`
window of the source channels, the same window of the filtered channels,
and, below the coarsest level, a `coarse_patch` x `coarse_patch` window
of both at level l+1 sampled at the parent pixel q//2.

Windows come from `F.unfold` on replicate-padded input, whose
channel-major (C*k*k) order is the reference's
`conv_general_dilated_patches` order: index c*k*k + dy*k + dx is channel
c at window offset (dy, dx).  Each feature is scaled by sqrt of its
Gaussian window weight, so plain L2 on the assembled vectors is the
weighted patch distance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SynthConfig


def extract_patches(img: torch.Tensor, patch: int) -> torch.Tensor:
    """(H, W) or (H, W, C) -> (H, W, C*patch*patch) edge-padded windows."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    r = patch // 2
    x = img.permute(2, 0, 1)[None]
    x = F.pad(x, (r, r, r, r), mode="replicate")
    cols = F.unfold(x, patch)  # (1, C*patch*patch, H*W), channel-major
    return cols[0].reshape(c * patch * patch, h, w).permute(1, 2, 0)


def _gauss_weights(patch: int, sigma_frac: float = 0.4) -> np.ndarray:
    """Per-offset Gaussian weights for one window, normalized to sum 1."""
    r = patch // 2
    sigma = max(patch * sigma_frac, 1e-3)
    y, x = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    w = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return (w / w.sum()).reshape(-1)


def feature_weights(
    n_src: int,
    n_flt: int,
    cfg: SynthConfig,
    has_coarse: bool,
    coarse_scale: float = 1.0,
) -> np.ndarray:
    """sqrt-weight vector matching the layout of `assemble_features`."""
    if cfg.gaussian_weighting:
        wf = _gauss_weights(cfg.patch_size)
        wc = _gauss_weights(cfg.coarse_patch_size)
    else:
        wf = np.full(cfg.patch_size**2, 1.0 / cfg.patch_size**2, np.float32)
        wc = np.full(
            cfg.coarse_patch_size**2, 1.0 / cfg.coarse_patch_size**2, np.float32
        )
    blocks = [np.tile(wf, n_src + n_flt)]
    if has_coarse:
        blocks.append(np.tile(wc, n_src + n_flt) * coarse_scale)
    return np.sqrt(np.concatenate(blocks)).astype(np.float32)


def assemble_features(
    src: torch.Tensor,
    flt: torch.Tensor,
    cfg: SynthConfig,
    src_coarse: Optional[torch.Tensor] = None,
    flt_coarse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The (H, W, D) feature tensor of one pyramid level; the coarse pair,
    when given, is the level-(l+1) images, looked up at q//2."""
    h, w = src.shape[:2]
    n_src = 1 if src.ndim == 2 else src.shape[-1]
    n_flt = 1 if flt.ndim == 2 else flt.shape[-1]
    parts = [
        extract_patches(src, cfg.patch_size),
        extract_patches(flt, cfg.patch_size),
    ]
    has_coarse = src_coarse is not None
    if has_coarse:
        iy = torch.arange(h, device=src.device) // 2
        ix = torch.arange(w, device=src.device) // 2
        for img in (src_coarse, flt_coarse):
            p = extract_patches(img, cfg.coarse_patch_size)
            parts.append(p.index_select(0, iy).index_select(1, ix))
    feats = torch.cat(parts, dim=-1)
    wvec = torch.as_tensor(
        feature_weights(n_src, n_flt, cfg, has_coarse), device=src.device
    )
    return feats * wvec

"""Row-slab helpers: a level's image split into row slabs with halos.

The lean path assembles its feature tables slab by slab
(models/analogy.py `assemble_features_lean`); the halo covers the
feature windows' reach, so slab cores see exactly the windows of the
whole image.  These are the port's own copies of the reference's
helpers; the spatial runner that also uses them there is not ported.
"""

from __future__ import annotations

import torch

from ..config import SynthConfig


def slab_halo(cfg: SynthConfig) -> int:
    """Rows of context on each side of a slab: the larger of the fine
    window's reach (patch_size // 2 rows) and the coarse window's
    (coarse_patch_size // 2 coarse rows, twice that in fine rows),
    rounded up to even so coarse slabs split at exactly half resolution
    (their halo is halo // 2)."""
    reach = max(cfg.patch_size // 2, 2 * (cfg.coarse_patch_size // 2))
    return reach + (reach % 2)


def _split_slabs(x: torch.Tensor, n_slabs: int, halo: int) -> torch.Tensor:
    """(H, ...) -> (n_slabs, H // n_slabs + 2 * halo, ...), edge-clamped."""
    h = x.shape[0]
    hs = h // n_slabs
    rows = torch.arange(-halo, h + halo, device=x.device).clamp(0, h - 1)
    xp = x.index_select(0, rows)
    return torch.stack(
        [xp[i * hs : i * hs + hs + 2 * halo] for i in range(n_slabs)]
    )

"""Configuration for image-analogy synthesis (PyTorch port).

Mirrors `image_analogies_tpu.config.SynthConfig` field for field, with the
same defaults and validation, plus one field: `device` ("cuda" by default;
"cpu" for tests).  A frozen dataclass, so configs are hashable.

`pallas_mode` keeps its three values but, in the port, chooses the
ALGORITHM rather than the device:
  - "off":       per-pixel `patchmatch_sweeps` on every level;
  - "auto":      the tile path on tile-eligible levels — a CUDA tensor
                 launches the hand-written kernel, a CPU tensor runs the
                 kernel's plain PyTorch version;
  - "interpret": the tile path with the plain version on either device
                 (explicit, for tests and the chip smoke check).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """All knobs for `create_image_analogy` (see the reference config for
    the measured rationale behind each default)."""

    levels: int = 5
    patch_size: int = 5
    coarse_patch_size: int = 3
    kappa: float = 0.0
    # Temporal-coherence weight (video).  Not ported yet: must stay 0.
    tau: float = 0.0
    matcher: str = "patchmatch"
    color_mode: str = "luminance"
    steerable: bool = False
    n_orientations: int = 4
    luminance_remap: bool = True

    pm_iters: int = 6
    em_iters: int = 3
    # Random-search scales per sweep of the per-pixel path (the tile
    # kernel's candidate budget is static: K_LOCAL/K_GLOBAL).
    pm_random_candidates: int = 6
    pm_polish_iters: int = 2
    pm_polish_random: int = 4
    pm_polish_final_only: bool = True
    seed: int = 0

    gaussian_weighting: bool = True
    pca_dims: Optional[int] = None
    match_dtype: str = "float32"
    pallas_mode: str = "auto"
    feature_bytes_budget: int = 2 * 1024**3
    brute_chunk: int = 4096
    brute_lean_bytes: int = 10 * 1024**3
    ann_eps: float = 0.5
    min_size: int = 16
    save_level_artifacts: Optional[str] = None

    # Port-only: where tensors live and kernels run.  "cuda" never falls
    # back to the CPU: a run on a machine without a card raises.
    device: str = "cuda"

    def __post_init__(self):
        if self.patch_size % 2 != 1 or self.coarse_patch_size % 2 != 1:
            raise ValueError("patch sizes must be odd")
        if self.color_mode not in ("luminance", "rgb"):
            raise ValueError(f"unknown color_mode {self.color_mode!r}")
        if self.levels < 1:
            raise ValueError("levels must be >= 1")
        if self.em_iters < 1 or self.pm_iters < 1:
            raise ValueError("em_iters and pm_iters must be >= 1")
        if self.tau < 0.0:
            raise ValueError("tau must be >= 0")
        if self.pm_polish_iters < 1 or self.pm_polish_random < 0:
            raise ValueError(
                "pm_polish_iters must be >= 1 and pm_polish_random >= 0"
            )
        if self.pallas_mode not in ("auto", "off", "interpret"):
            raise ValueError(f"unknown pallas_mode {self.pallas_mode!r}")
        if self.pca_dims is not None and self.pca_dims < 1:
            raise ValueError("pca_dims must be >= 1 (or None to disable)")
        if self.feature_bytes_budget < 1:
            raise ValueError("feature_bytes_budget must be >= 1")
        if self.brute_lean_bytes < 1:
            raise ValueError("brute_lean_bytes must be >= 1")
        if self.ann_eps < 0.0:
            raise ValueError("ann_eps must be >= 0")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")

    def clamp_levels(self, *shapes: Tuple[int, int]) -> int:
        """Number of usable pyramid levels for the given image shapes."""
        side = min(min(s[0], s[1]) for s in shapes)
        n = 1
        while n < self.levels and (side >> n) >= self.min_size:
            n += 1
        return n

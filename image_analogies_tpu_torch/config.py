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

`EngineModes` holds the matcher's four process-wide engine modes, which
are not config fields; `engine_modes()` reads them and
`set_engine_modes` installs them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """All knobs for `create_image_analogy` (see the reference config for
    the measured rationale behind each default)."""

    levels: int = 5
    patch_size: int = 5
    coarse_patch_size: int = 3
    kappa: float = 0.0
    # Temporal-coherence weight (video, video/sequence.py): warm frames'
    # PatchMatch candidates pay tau for diverging from the previous
    # frame's field (models/patchmatch.py `temporal_penalty_fn`).
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


# The polish engines `EngineModes.polish` may name (models/patchmatch.py).
_POLISH_MODES = ("sequential", "jump", "stream")


@dataclasses.dataclass(frozen=True)
class EngineModes:
    """The process-wide modes that choose the matcher's engines.  As in
    the reference, where they are module globals with environment
    overrides and setters, they are not config fields; every dispatch
    runs under them, so the serving tier keys its executables on them
    (serving/excache.compression_mode) and ships them to its follower
    ranks (serving/ranks.py).

      - `cand_dtype` (IA_CAND_DTYPE): "bf16", the uncompressed candidate
        tables (float32 sweep planes, bf16 polish rows), or "int8", both
        quantized (kernels/patchmatch_tile.py);
      - `prune` (IA_CAND_PRUNE): "off" or a "K:M" PCA pre-prune spec
        (`patchmatch_tile.parse_prune`);
      - `restart` (IA_RESTART_MODE): the K1 restart slots, "uniform" over
        A or "coarse", drawn from the evolving field;
      - `polish` (IA_POLISH_MODE): "sequential", "stream" or "jump"
        (models/patchmatch.py)."""

    cand_dtype: str = "bf16"
    prune: object = "off"
    restart: str = "uniform"
    polish: str = "sequential"


# Read once, unvalidated: a bad IA_CAND_DTYPE or IA_CAND_PRUNE raises
# where the matcher first resolves it, and IA_POLISH_MODE is not checked.
_ENGINE_MODES = EngineModes(
    cand_dtype=os.environ.get("IA_CAND_DTYPE", EngineModes.cand_dtype),
    prune=os.environ.get("IA_CAND_PRUNE", EngineModes.prune),
    restart=os.environ.get("IA_RESTART_MODE", EngineModes.restart),
    polish=os.environ.get("IA_POLISH_MODE", EngineModes.polish),
)


def engine_modes() -> EngineModes:
    """The engine modes the process runs under."""
    return _ENGINE_MODES


def set_engine_modes(modes: Optional[EngineModes] = None, /,
                     **changes) -> EngineModes:
    """Install `modes` (default: the current record) with `changes`
    applied, process-wide, and return the record it replaces, so that
    `set_engine_modes(prev)` restores it.  Each changed field is checked
    before anything is installed, as the reference's setters check it:
    `cand_dtype` by `resolve_cand_dtype`, `prune` by `parse_prune`,
    `polish` against its names; `restart` and a whole record go in as
    given.  (The reference's setters also drop its compiled level
    graphs; the port compiles none.)"""
    global _ENGINE_MODES
    from .kernels.patchmatch_tile import parse_prune, resolve_cand_dtype

    new = dataclasses.replace(
        _ENGINE_MODES if modes is None else modes, **changes)
    if "cand_dtype" in changes:
        resolve_cand_dtype(new.cand_dtype)
    if "prune" in changes:
        parse_prune(new.prune)
    if "polish" in changes and new.polish not in _POLISH_MODES:
        raise ValueError(
            f"polish mode {new.polish!r} names none of {_POLISH_MODES}")
    prev, _ENGINE_MODES = _ENGINE_MODES, new
    return prev

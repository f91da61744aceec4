"""Image I/O at the host edge: PIL decodes and encodes, everything between
`load_image` and `save_image` is float32 in [0, 1].  The port's own copy
of the reference's reader, writer and atomic artifact writers."""

from __future__ import annotations

import json
import os

import numpy as np


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """PNG/JPEG -> float32 [0, 1], (H, W, 3) or (H, W) when `gray`."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if gray else "RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def to_uint8(img) -> np.ndarray:
    """float [0, 1] array or tensor (on any device) -> the uint8 array
    `save_image` writes (round half up, clipped)."""
    if hasattr(img, "detach"):
        img = img.detach().float().cpu().numpy()
    arr = np.asarray(img)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(path: str, img) -> None:
    """float [0, 1] array or tensor -> 8-bit PNG/JPEG."""
    from PIL import Image

    Image.fromarray(to_uint8(img)).save(path)


def atomic_write_json(path: str, obj) -> None:
    """JSON to `path` via a temporary file and a rename, so a kill
    mid-write never leaves a truncated file where a consumer would read
    it (the checkpoint writer's discipline, `models/analogy._save_level`).
    Used for every telemetry artifact."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    """Text twin of `atomic_write_json` (same temporary file and rename),
    for the Prometheus exposition (`metrics.prom`)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)

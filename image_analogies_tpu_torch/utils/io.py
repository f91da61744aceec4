"""Image I/O at the host edge: PIL decodes, everything after `load_image`
is float32 in [0, 1].  The port's own copy of the reference's reader."""

from __future__ import annotations

import numpy as np


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """PNG/JPEG -> float32 [0, 1], (H, W, 3) or (H, W) when `gray`."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if gray else "RGB")
    return np.asarray(img, dtype=np.float32) / 255.0

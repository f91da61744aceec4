"""Procedural example assets — the port's own copy of
`image_analogies_tpu/utils/examples.py` (numpy only, value-identical), so
the port never imports the JAX package.

A, A', B image triples are generated procedurally with a fixed seed — one
generator per benchmark config family:

  - `texture_by_numbers`: label maps -> per-label procedural textures
    (config 1),
  - `artistic_filter`: photo-like base -> "watercolor" rendition
    (config 2: smoothed + edge-darkened + quantized),
  - `super_resolution`: A = blurred, A' = sharp (config 3),
  - `npr_frames`: a short synthetic "video" for the batched runner
    (config 5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _smooth_noise(rng, h, w, octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [0,1] (cheap Perlin stand-in)."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        grid = rng.random((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        v = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        out += amp * v
        total += amp
        amp *= 0.55
    return out / total


def _voronoi_labels(rng, h, w, n_cells: int) -> np.ndarray:
    """Integer label map from nearest-seed (Voronoi) regions."""
    pts = rng.random((n_cells, 2)) * [h, w]
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    return np.argmin(d, axis=-1) % 3


def _texture_for_label(rng, label: int, h: int, w: int) -> np.ndarray:
    """(H, W, 3) procedural texture, distinct statistics per label."""
    base = _smooth_noise(rng, h, w, octaves=5)
    if label == 0:  # grass-ish: high-freq green
        hf = rng.random((h, w)).astype(np.float32)
        tex = np.stack([0.15 + 0.2 * hf, 0.45 + 0.35 * base, 0.1 + 0.1 * hf], -1)
    elif label == 1:  # water-ish: smooth blue waves
        wave = 0.5 + 0.5 * np.sin(
            np.linspace(0, 20, w)[None, :] + 6 * base
        ).astype(np.float32)
        tex = np.stack([0.1 + 0.1 * base, 0.3 + 0.2 * wave, 0.55 + 0.35 * wave], -1)
    else:  # rock-ish: gray granular
        grain = 0.5 * base + 0.5 * rng.random((h, w)).astype(np.float32)
        tex = np.stack([0.45 + 0.3 * grain] * 3, -1)
    return tex.astype(np.float32)


def _label_colors(labels: np.ndarray) -> np.ndarray:
    palette = np.array(
        [[0.2, 0.8, 0.2], [0.2, 0.3, 0.9], [0.6, 0.6, 0.6]], np.float32
    )
    return palette[labels]


def texture_by_numbers(
    size: int = 256, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, A', B): A/B are flat-color label maps, A' the textured render."""
    rng = _rng(seed)
    lab_a = _voronoi_labels(rng, size, size, 12)
    lab_b = _voronoi_labels(rng, size, size, 9)
    a = _label_colors(lab_a)
    b = _label_colors(lab_b)
    textures = [_texture_for_label(rng, k, size, size) for k in range(3)]
    ap = np.stack(
        [np.choose(lab_a, [t[..., c] for t in textures]) for c in range(3)], -1
    )
    return a, ap.astype(np.float32), b


def _photo_like(rng, h, w) -> np.ndarray:
    """Smooth colorful synthetic 'photo'."""
    r = _smooth_noise(rng, h, w, 4)
    g = _smooth_noise(rng, h, w, 5)
    bl = _smooth_noise(rng, h, w, 3)
    return np.stack([r, g, bl], -1).astype(np.float32)


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable (2k+1)-tap box blur with edge padding (host-side helper)."""
    out = img.astype(np.float32)
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (k, k)
        p = np.pad(out, pad, mode="edge")
        acc = np.zeros_like(out)
        for off in range(2 * k + 1):
            acc += np.take(p, range(off, off + out.shape[axis]), axis=axis)
        out = acc / (2 * k + 1)
    return out


def watercolor(img: np.ndarray, levels: int = 6) -> np.ndarray:
    """Cheap 'watercolor' filter: smooth then quantize then edge-soften."""
    sm = _box_blur(img, 3)
    quant = np.round(sm * levels) / levels
    return (0.8 * quant + 0.2 * sm).astype(np.float32)


def artistic_filter(
    size: int = 512, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, A', B): A' = watercolor(A); analogy transfers the filter to B."""
    rng = _rng(seed)
    a = _photo_like(rng, size, size)
    b = _photo_like(rng, size, size)
    return a, watercolor(a), b


def super_resolution(
    size: int = 1024, seed: int = 2
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, A', B): A = blurred A', B = blurred target — B' 'deblurs' B."""
    rng = _rng(seed)
    ap = _photo_like(rng, size, size)
    sharp_b = _photo_like(rng, size, size)
    return _box_blur(ap, 2), ap, _box_blur(sharp_b, 2)


def texture_transfer(
    size: int = 256, seed: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, A', B): texture transfer (Hertzmann §4.4) — A and A' are both
    the *texture* (identity filter), B is an arbitrary target image;
    synthesized B' re-renders B out of the texture's material.  Run with
    kappa > 0 so coherent texture patches survive the luminance match."""
    rng = _rng(seed)
    tex = _texture_for_label(rng, 1, size, size)
    b = _photo_like(rng, size, size)
    return tex, tex.copy(), b


def npr_frames(
    n_frames: int = 8, size: int = 1024, seed: int = 3
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, A', frames): shared style pair + a drifting synthetic video.

    Frames are shifted/evolving views of one noise field so consecutive
    frames are temporally coherent, like the reference's NPR video use-case
    [BASELINE.json config 5].
    """
    rng = _rng(seed)
    a = _photo_like(rng, size, size)
    ap = watercolor(a)
    big = _photo_like(rng, size + 8 * n_frames, size + 8 * n_frames)
    frames = np.stack(
        [big[8 * i : 8 * i + size, 8 * i : 8 * i + size] for i in range(n_frames)]
    )
    return a, ap, frames

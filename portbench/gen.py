"""Input generators of the benchmark: a frozen copy of the port's
`utils/examples.py` generators the cells use, `super_resolution` and
`npr_frames` with their helpers, widened into the pools the mixes draw
from (a pool of one equals the original value for value).  Kept here so
that a later change to the program's examples cannot change what the
benchmark feeds it.

Every generator is numpy on the host, seeded by `np.random.default_rng`;
the benchmark's `--seed` (any non-negative whole number) becomes that
seed, so one seed gives one set of inputs.
"""

from __future__ import annotations

from typing import List, Tuple

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


def _photo_like(rng, h, w) -> np.ndarray:
    """Smooth colorful synthetic 'photo'."""
    r = _smooth_noise(rng, h, w, 4)
    g = _smooth_noise(rng, h, w, 5)
    bl = _smooth_noise(rng, h, w, 3)
    return np.stack([r, g, bl], -1).astype(np.float32)


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable (2k+1)-tap box blur with edge padding."""
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


# -- pools of the mixes ------------------------------------------------------


def seed_of(seed: int) -> int:
    """The benchmark's `--seed` as a numpy seed (non-negative)."""
    return int(seed) % (1 << 64)


def super_resolution_pool(
    size: int, seed: int, n_b: int
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """(A, A', [B_0 .. B_{n_b-1}]): A' a synthetic photo, A its box
    blur, and n_b blurred targets drawn on from the same stream (n_b = 1
    is `super_resolution(size, seed)`)."""
    rng = _rng(seed_of(seed))
    ap = _photo_like(rng, size, size)
    bs = [_box_blur(_photo_like(rng, size, size), 2) for _ in range(n_b)]
    return _box_blur(ap, 2), ap, bs


def npr_sequences(
    n_seq: int, n_frames: int, size: int, seed: int
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """(A, A', [frames_0 .. frames_{n_seq-1}]): a watercolor style pair
    and n_seq drifting sequences (shifted views of one noise field, so
    consecutive frames are temporally coherent) drawn on from the same
    stream (n_seq = 1 is `npr_frames(n_frames, size, seed)`)."""
    rng = _rng(seed_of(seed))
    a = _photo_like(rng, size, size)
    ap = watercolor(a)
    seqs = []
    for _ in range(n_seq):
        big = _photo_like(rng, size + 8 * n_frames, size + 8 * n_frames)
        seqs.append(np.stack([
            big[8 * i : 8 * i + size, 8 * i : 8 * i + size]
            for i in range(n_frames)
        ]))
    return a, ap, seqs

"""The plain reference of the `steerable` configuration: image analogies
with steerable-filter features by exact search, and the judge of the
program's answers.

Plain PyTorch, written from the method's description (Hertzmann et al.
2001, §3.1: a pixel's feature vector holds its luminance and,
optionally, oriented filter responses of it); it imports nothing of the
program.  It takes `reference.py`'s helpers for everything the
configurations share (colour, remap, pyramids, windows, exact search,
render, finalize) and adds:

  - the steerable bank: `n_orientations` first derivatives of a
    Gaussian (sigma 1, 5 x 5 taps), G_theta = cos(theta) Gx +
    sin(theta) Gy with theta = pi i / n, Gx = -x / sigma^2 g and Gy
    alike, both scaled to unit L2 norm; each applied by correlation over
    the edge-replicated luminance of every pyramid level (A's after the
    remap, B's as it is);
  - multi-channel features: the source side is the luminance and its n
    responses, the filtered side the luminance alone, and below the
    coarsest level the same of both one level up at q // 2.  With the
    5 x 5 and 3 x 3 windows and 4 orientations a row holds 6 x 25 +
    6 x 9 = 204 numbers, 150 at the coarsest level.

`prepare`, `oracle`, `match_far_share` and `judge` mean what they mean
in `reference.py`; `dtype=torch.bfloat16` in `prepare` gives the
control.  The searches' matmuls run in full float32 (TF32 off,
`reference._exact_f32`); nothing here convolves.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import reference as ref

BANK_SIZE = 5
BANK_SIGMA = 1.0


class Spec(NamedTuple):
    """What the reference needs of a configuration file's `synth`
    keys."""

    levels: int = 5
    patch_size: int = 5
    coarse_patch_size: int = 3
    em_iters: int = 3
    kappa: float = 0.0
    gaussian_weighting: bool = True
    luminance_remap: bool = True
    min_size: int = 16
    n_orientations: int = 4

    @classmethod
    def from_synth(cls, synth: Dict) -> "Spec":
        if synth.get("color_mode", "luminance") != "luminance":
            raise ValueError("the reference covers luminance mode only")
        if not synth.get("steerable", False):
            raise ValueError("this reference covers steerable features; "
                             "reference.py covers the rest")
        return cls(**{k: synth[k] for k in cls._fields if k in synth})


def bank(n_orientations: int, size: int = BANK_SIZE,
         sigma: float = BANK_SIGMA) -> np.ndarray:
    """(n, size, size) float64 taps, indexed [orientation, dy, dx]."""
    r = size // 2
    y, x = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float64)
    g = np.exp(-(x**2 + y**2) / (2.0 * sigma**2))
    gx = -x / sigma**2 * g
    gy = -y / sigma**2 * g
    gx = gx / math.sqrt(float((gx**2).sum()))
    gy = gy / math.sqrt(float((gy**2).sum()))
    thetas = [math.pi * i / n_orientations for i in range(n_orientations)]
    return np.stack([math.cos(t) * gx + math.sin(t) * gy for t in thetas])


def responses(y: torch.Tensor, n_orientations: int) -> torch.Tensor:
    """(h, w) luminance -> (h, w, n) oriented responses: each tap of the
    bank times the image shifted by its offset (edges replicated),
    summed, in y's dtype."""
    taps = bank(n_orientations)
    size = taps.shape[-1]
    r = size // 2
    h, w = y.shape
    out = [None] * n_orientations
    for dy in range(-r, r + 1):
        ry = (torch.arange(h, device=y.device) + dy).clamp(0, h - 1)
        for dx in range(-r, r + 1):
            cx = (torch.arange(w, device=y.device) + dx).clamp(0, w - 1)
            shifted = y[ry][:, cx]
            for i in range(n_orientations):
                term = shifted * float(taps[i, dy + r, dx + r])
                out[i] = term if out[i] is None else out[i] + term
    return torch.stack(out, dim=-1)


def with_responses(y: torch.Tensor, spec: Spec) -> torch.Tensor:
    """(h, w, 1 + n): the luminance and its responses."""
    return torch.cat([y[..., None], responses(y, spec.n_orientations)], -1)


def _channel_windows(img: torch.Tensor, k: int, weights: np.ndarray,
                     rows=None, cols=None) -> list:
    """`reference._windows` of each channel of an (h, w) or (h, w, C)
    image."""
    chans = [img] if img.ndim == 2 else list(img.unbind(-1))
    return [ref._windows(c, k, weights, rows, cols) for c in chans]


def features(src, flt, src_c, flt_c, spec: Spec) -> torch.Tensor:
    """(h*w, D) feature rows of one level: a `patch_size` window of every
    source channel and of the filtered luminance, and with the coarse
    pair a `coarse_patch_size` window of every channel of both one level
    up at q // 2; each tap scaled by the square root of its Gaussian
    weight."""
    h, w = src.shape[:2]
    wf = ref._window_weights(spec.patch_size, spec.gaussian_weighting)
    parts = (_channel_windows(src, spec.patch_size, wf)
             + _channel_windows(flt, spec.patch_size, wf))
    if src_c is not None:
        wc = ref._window_weights(spec.coarse_patch_size,
                                 spec.gaussian_weighting)
        iy = torch.arange(h, device=src.device) // 2
        ix = torch.arange(w, device=src.device) // 2
        for img in (src_c, flt_c):
            parts += _channel_windows(img, spec.coarse_patch_size, wc, iy,
                                      ix)
    f = torch.cat(parts, dim=-1)
    return f.reshape(h * w, -1)


class Prepared(NamedTuple):
    """The reference's prologue of one (A, A', B): `reference.Prepared`'s
    luminance pyramids and B's YIQ, with the source-side stacks of every
    level (luminance and responses) of A (remapped) and of B."""

    y_a: list
    y_ap: list
    y_b: list
    yiq_b: torch.Tensor
    levels: int
    s_a: list
    s_b: list


def prepare(a, ap, b, spec: Spec, b_stats=None,
            dtype=torch.float32) -> Prepared:
    """`reference.prepare` with the steerable bank on every level."""
    p = ref.prepare(a, ap, b, spec, b_stats=b_stats, dtype=dtype)
    return Prepared(*p, [with_responses(y, spec) for y in p.y_a],
                    [with_responses(y, spec) for y in p.y_b])


def oracle(p: Prepared, spec: Spec, chunk: int = 2048):
    """Exact-search synthesis: (B' RGB, finest field (h, w, 2)), in the
    dtype `p` was prepared in."""
    prev_bp = prev_nnf = None
    with ref._exact_f32():
        for lv in range(p.levels - 1, -1, -1):
            has_c = lv < p.levels - 1
            h, w = p.y_b[lv].shape
            ha, wa = p.y_a[lv].shape
            if has_c:
                flt, flt_c = ref.upsample(prev_bp, h, w), prev_bp
            else:
                flt = flt_c = p.y_b[lv]
            f_a = features(p.s_a[lv], p.y_ap[lv],
                           p.s_a[lv + 1] if has_c else None,
                           p.y_ap[lv + 1] if has_c else None, spec)
            for _ in range(spec.em_iters):
                f_b = features(p.s_b[lv], flt,
                               p.s_b[lv + 1] if has_c else None,
                               flt_c if has_c else None, spec)
                idx, dist = ref.exact_nn(f_b, f_a, chunk)
                py, px = (idx // wa).reshape(h, w), (idx % wa).reshape(h, w)
                if spec.kappa > 0.0:
                    py, px, _ = ref.coherence(
                        py, px, dist.reshape(h, w), f_b, f_a, ha, wa,
                        1.0 + spec.kappa * 2.0 ** (-lv))
                flt = p.y_ap[lv][py, px]
                del f_b
            prev_bp, prev_nnf = flt, torch.stack([py, px], -1)
            del f_a
    return ref.finalize(prev_bp, p.yiq_b), prev_nnf


def match_far_share(p: Prepared, spec: Spec, nnf: torch.Tensor,
                    sample: Optional[torch.Tensor] = None,
                    chunk: int = 2048) -> float:
    """`reference.match_far_share` in the steerable features: the share
    of B pixels whose match through the field lies more than
    `reference.FAR` times as far as the exact nearest neighbour over all
    of A, at the finest level, B' being the render of the field and its
    level up B''s pyramid."""
    py, px = nnf[..., 0].long(), nnf[..., 1].long()
    wa = p.y_ap[0].shape[1]
    flt = p.y_ap[0][py, px]
    has_c = p.levels > 1
    f_b = features(p.s_b[0], flt, p.s_b[1] if has_c else None,
                   ref.pyramid(flt, 2)[1] if has_c else None, spec)
    f_a = features(p.s_a[0], p.y_ap[0], p.s_a[1] if has_c else None,
                   p.y_ap[1] if has_c else None, spec)
    match = (py * wa + px).reshape(-1)
    if sample is not None:
        f_b, match = f_b.index_select(0, sample), match.index_select(0, sample)
    diff = f_b - f_a.index_select(0, match)
    mine = (diff * diff).sum(-1)
    del diff
    with ref._exact_f32():
        _, best = ref.exact_nn(f_b, f_a, chunk)
    return float((mine > ref.FAR * best).double().mean())


def judge(out: torch.Tensor, nnf: torch.Tensor, p: Prepared, spec: Spec,
          oracle_out: Optional[torch.Tensor] = None,
          sample: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The numbers compared for one answer (B' RGB, finest field), with
    `p` prepared in float32: `render_max_abs`, `match_far_share` (on the
    `sample` of pixels), and with `oracle_out` (the float32 oracle's B')
    `psnr_db`; as `reference.judge`."""
    bad = {"render_max_abs": float("inf"), "match_far_share": 1.0}
    if oracle_out is not None:
        bad["psnr_db"] = float("-inf")
    if tuple(out.shape) != tuple(p.yiq_b.shape):
        return bad
    dev = p.yiq_b.device
    out, nnf = out.to(dev), nnf.to(dev)
    mine = ref.render(p, nnf)
    if mine is None:
        return bad
    got = {"render_max_abs": (
        float((out.double() - mine.double()).abs().max())
        if bool(torch.isfinite(out).all()) else float("inf"))}
    got["match_far_share"] = match_far_share(
        p, spec, nnf, None if sample is None else sample.to(dev))
    if oracle_out is not None:
        got["psnr_db"] = ref.psnr(out, oracle_out)
    return got

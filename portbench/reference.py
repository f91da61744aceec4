"""The plain reference of the benchmark: image analogies by exact search,
and the judge of the program's answers.

Plain PyTorch, written from the method's semantics (Hertzmann et al.
2001, luminance mode, as the configuration files under `configs/` state
it); it imports nothing of the program.  It works out again from A, A'
and B everything the program derives from them:

  - RGB <-> YIQ, the luminance remap of A and A' to B's statistics (or to
    a whole frame stack's, for the batch runner);
  - the Gaussian pyramids (edge-padded 5-tap binomial, stride 2) and the
    bilinear upsample of B' between levels;
  - the feature vectors: a `patch_size` window of the source and the
    filtered luminance, and below the coarsest level a
    `coarse_patch_size` window of both one level up at q // 2, each tap
    scaled by the square root of its Gaussian weight;
  - per level `em_iters` steps of exact nearest-neighbour search over
    every A pixel (with `kappa` > 0, Ashikhmin coherence sweeps after
    it), each followed by the render B'(q) = A'(s(q));
  - the finalize: B's chroma back, clipped to [0, 1].

`oracle` is that synthesis.  `judge` holds one answer of the program (B'
and the finest level's field) against it:

  - `render_max_abs`: the largest gap between the answer's B' and the
    render of ITS OWN field by the reference (A' luminance remapped,
    gathered, B's chroma, clipped).  This covers the colour conversion,
    the remap, the render and the finalize, and every pixel of the
    answer;
  - `match_far_share`: the share of the answer's pixels whose match at
    the finest level lies more than `FAR` times as far (squared feature
    distance) as the exact nearest neighbour, with the features the
    method builds there from B, the answer's own B' and A, A'.  This
    covers the matchers: PatchMatch leaves most pixels within a few
    times the nearest, and a search that is cut short, or made in a
    lower precision, leaves many more far off;
  - `psnr_db`: the answer's B' against the oracle's B'.  This covers the
    pyramids, the features and every level's match, coarsely: a
    different but sound field reads a few dB below.

The same code runs in bfloat16 (`dtype=torch.bfloat16`) as the control:
the reference put in the program's place one precision below the
float32 the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

_RGB2YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.595716, -0.274453, -0.321263],
        [0.211456, -0.522591, 0.311135],
    ],
    dtype=np.float64,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ)
_BINOMIAL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
_DELTAS = ((0, -1), (0, 1), (-1, 0), (1, 0))
# A match "far off": more than this many times the squared feature
# distance of the exact nearest neighbour (`match_far_share`).
FAR = 8.0


class Spec(NamedTuple):
    """What the reference needs of a configuration file's `synth` keys."""

    levels: int = 5
    patch_size: int = 5
    coarse_patch_size: int = 3
    em_iters: int = 2
    kappa: float = 0.0
    gaussian_weighting: bool = True
    luminance_remap: bool = True
    min_size: int = 16

    @classmethod
    def from_synth(cls, synth: Dict) -> "Spec":
        if synth.get("color_mode", "luminance") != "luminance":
            raise ValueError("the reference covers luminance mode only")
        if synth.get("steerable", False):
            raise ValueError("the reference covers no steerable features")
        return cls(**{k: synth[k] for k in cls._fields if k in synth})


@contextlib.contextmanager
def _exact_f32():
    """Matmuls in full float32 (no TF32) while the reference runs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mix3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    rows = [
        x[..., 0] * float(r[0]) + x[..., 1] * float(r[1])
        + x[..., 2] * float(r[2])
        for r in m.astype(np.float32)
    ]
    return torch.stack(rows, dim=-1)


def rgb_to_yiq(x: torch.Tensor) -> torch.Tensor:
    return _mix3(x, _RGB2YIQ)


def yiq_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return _mix3(x, _YIQ2RGB)


def n_levels(spec: Spec, *shapes) -> int:
    """Pyramid levels: halve while the smaller side stays >= min_size."""
    side = min(min(s[0], s[1]) for s in shapes)
    n = 1
    while n < spec.levels and (side >> n) >= spec.min_size:
        n += 1
    return n


def stats(y: torch.Tensor) -> Tuple[float, float]:
    """Mean and population standard deviation, in float64."""
    y = y.double()
    return float(y.mean()), float(y.std(correction=0))


def _blur_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(-2, n + 2, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)
    out = None
    for i, k in enumerate(_BINOMIAL):
        term = xp.narrow(axis, i, n) * k
        out = term if out is None else out + term
    return out


def blur(x: torch.Tensor) -> torch.Tensor:
    """Edge-padded separable 5-tap binomial, rows then columns."""
    return _blur_axis(_blur_axis(x, 0), 1)


def pyramid(x: torch.Tensor, levels: int):
    out = [x]
    for _ in range(levels - 1):
        out.append(blur(out[-1])[::2, ::2].contiguous())
    return out


def upsample(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres and edge clamping."""
    def coords(n_out, n_in):
        s = (torch.arange(n_out, device=x.device, dtype=torch.float64)
             + 0.5) * (n_in / n_out) - 0.5
        s = s.clamp(min=0.0)
        i0 = s.floor().long().clamp(max=n_in - 1)
        i1 = (i0 + 1).clamp(max=n_in - 1)
        return i0, i1, (s - i0).to(x.dtype)

    y0, y1, fy = coords(h, x.shape[0])
    x0, x1, fx = coords(w, x.shape[1])
    top = x[y0][:, x0] * (1 - fx) + x[y0][:, x1] * fx
    bot = x[y1][:, x0] * (1 - fx) + x[y1][:, x1] * fx
    return top * (1 - fy[:, None]) + bot * fy[:, None]


def _window_weights(k: int, gaussian: bool) -> np.ndarray:
    if not gaussian:
        return np.full(k * k, 1.0 / (k * k))
    r = k // 2
    sigma = max(k * 0.4, 1e-3)
    y, x = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float64)
    w = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return (w / w.sum()).reshape(-1)


def _windows(img: torch.Tensor, k: int, weights: np.ndarray,
             rows: Optional[torch.Tensor] = None,
             cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(h, w, k*k) edge-padded windows of a 2-D image, each tap scaled by
    sqrt(weight); `rows`/`cols` pick the centres (default every pixel)."""
    h, w = img.shape
    r = k // 2
    rows = torch.arange(h, device=img.device) if rows is None else rows
    cols = torch.arange(w, device=img.device) if cols is None else cols
    taps = []
    for dy in range(-r, r + 1):
        ry = (rows + dy).clamp(0, h - 1)
        for dx in range(-r, r + 1):
            cx = (cols + dx).clamp(0, w - 1)
            wt = math.sqrt(float(weights[(dy + r) * k + dx + r]))
            taps.append(img[ry][:, cx] * wt)
    return torch.stack(taps, dim=-1)


def features(src, flt, src_c, flt_c, spec: Spec) -> torch.Tensor:
    """(h*w, D) feature rows of one level."""
    h, w = src.shape
    wf = _window_weights(spec.patch_size, spec.gaussian_weighting)
    parts = [_windows(src, spec.patch_size, wf),
             _windows(flt, spec.patch_size, wf)]
    if src_c is not None:
        wc = _window_weights(spec.coarse_patch_size, spec.gaussian_weighting)
        iy = torch.arange(h, device=src.device) // 2
        ix = torch.arange(w, device=src.device) // 2
        for img in (src_c, flt_c):
            parts.append(_windows(img, spec.coarse_patch_size, wc, iy, ix))
    f = torch.cat(parts, dim=-1)
    return f.reshape(h * w, -1)


def exact_nn(f_b: torch.Tensor, f_a: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmin_p ||f_b[q] - f_a[p]||^2 for every q, in f_b's dtype; the
    winners' distances recomputed by direct subtraction."""
    a_sq = (f_a * f_a).sum(-1)
    f_at = f_a.t().contiguous()
    idx = torch.empty(f_b.shape[0], dtype=torch.long, device=f_b.device)
    for c in range(0, f_b.shape[0], chunk):
        q = f_b[c : c + chunk]
        scores = torch.addmm(a_sq[None, :], q, f_at, alpha=-2.0)
        idx[c : c + chunk] = scores.argmin(dim=1)
        del scores
    diff = f_b - f_a.index_select(0, idx)
    return idx, (diff * diff).sum(-1)


def coherence(py, px, dist, f_b, f_a, ha, wa, factor, sweeps=2):
    """Ashikhmin sweeps: each pixel tries its neighbours' matches shifted
    by the offset and takes one that beats the best coherent candidate
    so far and stays within factor x its exact distance."""
    ceiling = dist * factor
    best = torch.full_like(dist, float("inf"))
    for _ in range(sweeps):
        for dy, dx in _DELTAS:
            cy = (torch.roll(py, (dy, dx), (0, 1)) + dy).clamp(0, ha - 1)
            cx = (torch.roll(px, (dy, dx), (0, 1)) + dx).clamp(0, wa - 1)
            cand = (cy * wa + cx).reshape(-1)
            diff = f_b - f_a.index_select(0, cand)
            d = (diff * diff).sum(-1).reshape(py.shape)
            ok = (d < best) & (d <= ceiling)
            py = torch.where(ok, cy, py)
            px = torch.where(ok, cx, px)
            dist = torch.where(ok, d, dist)
            best = torch.where(ok, d, best)
    return py, px, dist


class Prepared(NamedTuple):
    """The reference's prologue of one (A, A', B): luminance pyramids of
    A and A' (remapped) and of B, and B's YIQ."""

    y_a: list
    y_ap: list
    y_b: list
    yiq_b: torch.Tensor
    levels: int


def prepare(a, ap, b, spec: Spec, b_stats=None,
            dtype=torch.float32) -> Prepared:
    """`b_stats` (mean, std) overrides B's own luminance statistics (a
    frame stack's)."""
    a, ap, b = (x.to(dtype) for x in (a, ap, b))
    yiq_b = rgb_to_yiq(b)
    y_b = yiq_b[..., 0]
    y_a = rgb_to_yiq(a)[..., 0]
    y_ap = rgb_to_yiq(ap)[..., 0]
    if spec.luminance_remap:
        mu_a, sd_a = stats(y_a)
        mu_b, sd_b = b_stats if b_stats is not None else stats(y_b)
        scale = sd_b / max(sd_a, 1e-6)
        y_a = (y_a - mu_a) * scale + mu_b
        y_ap = (y_ap - mu_a) * scale + mu_b
    levels = n_levels(spec, a.shape[:2], b.shape[:2])
    return Prepared(pyramid(y_a, levels), pyramid(y_ap, levels),
                    pyramid(y_b, levels), yiq_b, levels)


def finalize(y: torch.Tensor, yiq_b: torch.Tensor) -> torch.Tensor:
    return yiq_to_rgb(torch.stack([y, yiq_b[..., 1], yiq_b[..., 2]], -1)
                      ).clamp(0.0, 1.0)


def oracle(p: Prepared, spec: Spec, chunk: int = 2048):
    """Exact-search synthesis: (B' RGB, finest field (h, w, 2)), in the
    dtype `p` was prepared in."""
    prev_bp = prev_nnf = None
    with _exact_f32():
        for lv in range(p.levels - 1, -1, -1):
            has_c = lv < p.levels - 1
            h, w = p.y_b[lv].shape
            ha, wa = p.y_a[lv].shape
            if has_c:
                flt, flt_c = upsample(prev_bp, h, w), prev_bp
            else:
                flt = flt_c = p.y_b[lv]
            f_a = features(p.y_a[lv], p.y_ap[lv],
                           p.y_a[lv + 1] if has_c else None,
                           p.y_ap[lv + 1] if has_c else None, spec)
            for _ in range(spec.em_iters):
                f_b = features(p.y_b[lv], flt,
                               p.y_b[lv + 1] if has_c else None,
                               flt_c if has_c else None, spec)
                idx, dist = exact_nn(f_b, f_a, chunk)
                py, px = (idx // wa).reshape(h, w), (idx % wa).reshape(h, w)
                if spec.kappa > 0.0:
                    py, px, _ = coherence(
                        py, px, dist.reshape(h, w), f_b, f_a, ha, wa,
                        1.0 + spec.kappa * 2.0 ** (-lv))
                flt = p.y_ap[lv][py, px]
                del f_b
            prev_bp, prev_nnf = flt, torch.stack([py, px], -1)
            del f_a
    return finalize(prev_bp, p.yiq_b), prev_nnf


def render(p: Prepared, nnf: torch.Tensor) -> Optional[torch.Tensor]:
    """B' RGB of a finest-level field under the reference's prologue, or
    None when the field points outside A."""
    ha, wa = p.y_ap[0].shape
    py, px = nnf[..., 0].long(), nnf[..., 1].long()
    if (py.min() < 0 or px.min() < 0 or py.max() >= ha or px.max() >= wa):
        return None
    return finalize(p.y_ap[0][py, px], p.yiq_b)


def psnr(x: torch.Tensor, y: torch.Tensor) -> float:
    mse = float(((x.double() - y.double()) ** 2).mean())
    return float("inf") if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def match_far_share(p: Prepared, spec: Spec, nnf: torch.Tensor,
                    sample: Optional[torch.Tensor] = None,
                    chunk: int = 2048) -> float:
    """The share of B pixels whose match through the field lies more than
    `FAR` times as far as the exact nearest neighbour over all of A, at
    the finest level.  The B side's features are the method's (B's and
    B''s windows, and one level up B's and B''s), with B' the render of
    this field (A' remapped, gathered) and its level up that B''s
    pyramid; the A side's are the oracle's.  `sample` picks the B pixels
    compared (default every one); the field has to lie inside A."""
    py, px = nnf[..., 0].long(), nnf[..., 1].long()
    wa = p.y_ap[0].shape[1]
    flt = p.y_ap[0][py, px]
    has_c = p.levels > 1
    f_b = features(p.y_b[0], flt, p.y_b[1] if has_c else None,
                   pyramid(flt, 2)[1] if has_c else None, spec)
    f_a = features(p.y_a[0], p.y_ap[0], p.y_a[1] if has_c else None,
                   p.y_ap[1] if has_c else None, spec)
    match = (py * wa + px).reshape(-1)
    if sample is not None:
        f_b, match = f_b.index_select(0, sample), match.index_select(0, sample)
    diff = f_b - f_a.index_select(0, match)
    mine = (diff * diff).sum(-1)
    del diff
    with _exact_f32():
        _, best = exact_nn(f_b, f_a, chunk)
    return float((mine > FAR * best).double().mean())


def sample_rows(n: int, count: int, seed: int) -> Optional[torch.Tensor]:
    """`count` of n pixel indices drawn from `seed` (None: every one)."""
    if n <= count:
        return None
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return torch.randperm(n, generator=g)[:count]


def judge(out: torch.Tensor, nnf: torch.Tensor, p: Prepared, spec: Spec,
          oracle_out: Optional[torch.Tensor] = None,
          sample: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The numbers compared for one answer (B' RGB, finest field), with
    `p` prepared in float32: `render_max_abs`, `match_far_share` (on the
    `sample` of pixels), and with `oracle_out` (the float32 oracle's B')
    `psnr_db`."""
    bad = {"render_max_abs": float("inf"), "match_far_share": 1.0}
    if oracle_out is not None:
        bad["psnr_db"] = float("-inf")
    if tuple(out.shape) != tuple(p.yiq_b.shape):
        return bad
    dev = p.yiq_b.device
    out, nnf = out.to(dev), nnf.to(dev)
    mine = render(p, nnf)
    if mine is None:
        return bad
    got = {"render_max_abs": (
        float((out.double() - mine.double()).abs().max())
        if bool(torch.isfinite(out).all()) else float("inf"))}
    got["match_far_share"] = match_far_share(
        p, spec, nnf, None if sample is None else sample.to(dev))
    if oracle_out is not None:
        got["psnr_db"] = psnr(out, oracle_out)
    return got

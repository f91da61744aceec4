"""Coarse-to-fine analogy synthesis: `create_image_analogy(A, A', B) -> B'`.

Per pyramid level (coarsest first), the level loop upsamples the coarser
level's state (or draws a random field at the coarsest level), assembles
the A-side features and the tile path's A planes once, then alternates
`em_iters` times
    1. match:  NN field from full-window features of the current B',
    2. render: B'(q) <- A'(s(q)).
Luminance mode matches on Y (plus steerable responses when asked) and
copies B's chroma back at the end (Hertzmann §3.4).

This is the standard path of the reference's single-image runner.  The
lean path (levels whose feature tables pass `feature_bytes_budget`, or
`brute_lean_bytes` for brute) and checkpoint writing are not ported yet
and raise.  A run can start at a level from per-level state saved by the
JAX package (`load_level_state`).
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import SynthConfig
from ..kernels import tile_path
from ..ops.color import luminance, rgb_to_yiq, yiq_to_rgb
from ..ops.features import assemble_features
from ..ops.pca import fit_and_project, project
from ..ops.pyramid import build_pyramid, upsample
from ..ops.remap import remap_luminance
from ..ops.steerable import steerable_responses
from .matcher import clamp_nnf, get_matcher
from .patchmatch import RawPlanes, SweepDraws, init_generator, random_init

# Register the built-in matchers.
from . import brute as _brute  # noqa: F401
from . import coherence as _coherence  # noqa: F401
from . import patchmatch as _patchmatch  # noqa: F401


def resolve_device(cfg: SynthConfig) -> torch.device:
    """The run's device.  "cuda" on a machine without a card raises: a
    run never carries on on the CPU."""
    if cfg.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SynthConfig.device is 'cuda' but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device(cfg.device)


def _with_steerable(y: torch.Tensor, cfg: SynthConfig) -> torch.Tensor:
    """Source-side match channels: luminance (+ steerable bank of Y)."""
    if not cfg.steerable:
        return y
    resp = steerable_responses(luminance(y), cfg.n_orientations)
    if y.ndim == 2:
        y = y[..., None]
    return torch.cat([y, resp], dim=-1)


def _gather_image(img: torch.Tensor, nnf: torch.Tensor) -> torch.Tensor:
    """B'(q) = img(s(q)): row-gather of the copy channels."""
    ha, wa = img.shape[:2]
    flat = img.reshape(ha * wa, -1)
    idx = (nnf[..., 0] * wa + nnf[..., 1]).reshape(-1)
    out = flat.index_select(0, idx).reshape(*nnf.shape[:2], -1)
    return out[..., 0] if img.ndim == 2 else out


def upsample_nnf(nnf: torch.Tensor, target_shape, ha: int,
                 wa: int) -> torch.Tensor:
    """s-map to the next finer level: parent offsets doubled + child
    parity."""
    h, w = target_shape
    up = nnf.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] * 2
    py = torch.arange(h, device=nnf.device)[:, None].expand(h, w) % 2
    px = torch.arange(w, device=nnf.device)[None, :].expand(h, w) % 2
    return clamp_nnf(up + torch.stack([py, px], dim=-1), ha, wa)


def _level_state_glue(prev_nnf, prev_bp, raw_b_l, h: int, w: int, ha: int,
                      wa: int, gen_init):
    """Incoming state of one level: the coarser level's (nnf, B')
    upsampled, or a random field and B itself at the coarsest level.
    Returns (nnf, flt_bp, flt_bp_coarse)."""
    if prev_nnf is not None:
        nnf = upsample_nnf(prev_nnf, (h, w), ha, wa)
        return nnf, upsample(prev_bp, (h, w)), prev_bp
    return random_init(gen_init, h, w, ha, wa), raw_b_l, raw_b_l


def make_em_step(cfg: SynthConfig, level: int, has_coarse: bool,
                 polish_iters=None):
    """One EM step at one level: features -> match -> render."""
    matcher = get_matcher(cfg.matcher)

    def em_step(src_b, flt_b, src_b_c, flt_b_c, f_a, copy_a, nnf,
                draws: SweepDraws, proj=None, a_planes=None, plan=None):
        f_b = assemble_features(
            src_b, flt_b, cfg,
            src_b_c if has_coarse else None,
            flt_b_c if has_coarse else None,
        )
        if cfg.pca_dims:
            f_b = project(f_b, proj)
        raw = None
        if plan is not None:
            raw = RawPlanes(
                src_b, flt_b,
                src_b_c if has_coarse else None,
                flt_b_c if has_coarse else None,
                a_planes, plan,
            )
        nnf, dist = matcher.match(
            f_b, f_a, nnf, level=level, cfg=cfg, draws=draws, raw=raw,
            polish_iters=polish_iters,
        )
        return nnf, dist, _gather_image(copy_a, nnf)

    return em_step


def _feature_table_bytes(h: int, w: int, ha: int, wa: int) -> int:
    """The reference's estimate of the feature tables' device bytes,
    which decides the lean path (kept so both packages pick the same
    path at the same sizes)."""
    return (h * w + ha * wa) * 128 * 4


def plan_level(cfg: SynthConfig, level: int, src_a_l, flt_a_l,
               has_coarse: bool, h: int, w: int):
    """The tile plan (specs, use_coarse) of this level, or None for the
    matcher's non-tile path.  Raises where the reference would take the
    lean path, which is not ported yet."""
    from ..kernels.patchmatch_tile import plan_channels

    ha, wa = src_a_l.shape[:2]
    table_bytes = _feature_table_bytes(h, w, ha, wa)
    plan = None
    if cfg.matcher == "patchmatch" and tile_path(cfg):
        n_src = 1 if src_a_l.ndim == 2 else src_a_l.shape[-1]
        n_flt = 1 if flt_a_l.ndim == 2 else flt_a_l.shape[-1]
        plan = plan_channels(n_src, n_flt, cfg, has_coarse, h, w, ha, wa)
    lean = (
        table_bytes > cfg.brute_lean_bytes if cfg.matcher == "brute"
        else plan is not None and table_bytes > cfg.feature_bytes_budget
    )
    if lean:
        raise NotImplementedError(
            f"level {level} ({h}x{w}) takes the lean path, which the "
            "PyTorch port does not have yet"
        )
    return plan


def _resolve_channels(a, ap, b, cfg: SynthConfig):
    """Split inputs into (match-src, match-flt, match-b, copy, yiq_b)."""
    if cfg.color_mode == "luminance":
        color = b.ndim == 3
        yiq_b = rgb_to_yiq(b) if color else None
        y_b = yiq_b[..., 0] if color else b
        y_a = rgb_to_yiq(a)[..., 0] if a.ndim == 3 else a
        y_ap = rgb_to_yiq(ap)[..., 0] if ap.ndim == 3 else ap
        if cfg.luminance_remap:
            y_a, y_ap = remap_luminance(y_a, y_ap, y_b)
        return y_a, y_ap, y_b, y_ap, yiq_b
    return a, ap, b, ap, None


def prologue(a, ap, b, cfg: SynthConfig, levels: int):
    """Channel resolve + luminance remap + every pyramid + steerable
    banks: (pyr_src_a, pyr_flt_a, pyr_src_b, pyr_copy_a, pyr_raw_b,
    yiq_b)."""
    src_a, flt_a, src_b, copy_a, yiq_b = _resolve_channels(a, ap, b, cfg)
    pyr_src_a = [_with_steerable(x, cfg) for x in build_pyramid(src_a, levels)]
    pyr_flt_a = build_pyramid(flt_a, levels)
    pyr_raw_b = build_pyramid(src_b, levels)
    pyr_src_b = [_with_steerable(x, cfg) for x in pyr_raw_b]
    pyr_copy_a = build_pyramid(copy_a, levels)
    return pyr_src_a, pyr_flt_a, pyr_src_b, pyr_copy_a, pyr_raw_b, yiq_b


def run_level(cfg: SynthConfig, level: int, levels: int, pyr, prev_nnf,
              prev_bp):
    """One pyramid level: state glue, A-side features (+PCA), the tile
    path's A planes, then `em_iters` EM steps.  Returns (nnf, dist, bp)."""
    from ..kernels.patchmatch_tile import prepare_a_planes

    pyr_src_a, pyr_flt_a, pyr_src_b, pyr_copy_a, pyr_raw_b, _ = pyr
    has_coarse = level < levels - 1
    src_a_l, flt_a_l = pyr_src_a[level], pyr_flt_a[level]
    src_a_c = pyr_src_a[level + 1] if has_coarse else None
    flt_a_c = pyr_flt_a[level + 1] if has_coarse else None
    src_b_l = pyr_src_b[level]
    src_b_c = pyr_src_b[level + 1] if has_coarse else None
    h, w = src_b_l.shape[:2]
    ha, wa = src_a_l.shape[:2]

    plan = plan_level(cfg, level, src_a_l, flt_a_l, has_coarse, h, w)
    f_a = assemble_features(src_a_l, flt_a_l, cfg, src_a_c, flt_a_c)
    f_a, proj = fit_and_project(f_a, cfg.pca_dims)
    a_planes = None
    if plan is not None:
        # float32 or int8 planes, under the module's resolved cand_dtype
        # (the matcher's sweeps check they agree).
        specs, use_coarse = plan
        a_planes = prepare_a_planes(
            src_a_l, flt_a_l,
            src_a_c if use_coarse else None,
            flt_a_c if use_coarse else None,
            specs,
        )

    nnf, flt_bp, flt_bp_coarse = _level_state_glue(
        prev_nnf, prev_bp, pyr_raw_b[level], h, w, ha, wa,
        init_generator(cfg.seed, level, src_b_l.device),
    )
    step_final = make_em_step(cfg, level, has_coarse)
    step_mid = (
        make_em_step(cfg, level, has_coarse, polish_iters=0)
        if cfg.pm_polish_final_only else step_final
    )
    dist = bp = None
    for em in range(cfg.em_iters):
        step = step_final if em == cfg.em_iters - 1 else step_mid
        nnf, dist, bp = step(
            src_b_l, flt_bp,
            src_b_c if has_coarse else src_b_l,
            flt_bp_coarse if has_coarse else flt_bp,
            f_a, pyr_copy_a[level], nnf,
            SweepDraws(cfg.seed, level, em), proj, a_planes, plan,
        )
        flt_bp = bp
    return nnf, dist, bp


class LevelState(NamedTuple):
    """Converged state of one pyramid level: the NN field (H, W, 2)
    int64, its distances (H, W) and the synthesized copy-channel image."""

    level: int
    nnf: torch.Tensor
    dist: torch.Tensor
    bp: torch.Tensor


def load_level_state(path_or_arrays: Union[str, os.PathLike, Dict],
                     level: int, device="cuda") -> LevelState:
    """Per-level state saved by the JAX package (`level_{L}.npz` with
    `nnf` (H, W, 2) int32, `dist`, `bp`, in a checkpoint directory), or
    a dict of those arrays, as port tensors on `device`."""
    if isinstance(path_or_arrays, dict):
        data = path_or_arrays
    else:
        with np.load(os.path.join(path_or_arrays, f"level_{level}.npz")) as z:
            data = {k: z[k] for k in ("nnf", "dist", "bp")}
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to load the level state onto")
    nnf = torch.as_tensor(np.asarray(data["nnf"]), device=dev).long()
    if nnf.ndim != 3 or nnf.shape[-1] != 2:
        raise ValueError(f"nnf must be (H, W, 2), got {tuple(nnf.shape)}")
    return LevelState(
        level,
        nnf,
        torch.as_tensor(np.asarray(data["dist"], np.float32), device=dev),
        torch.as_tensor(np.asarray(data["bp"], np.float32), device=dev),
    )


def _finalize(bp, yiq_b, b, cfg: SynthConfig):
    """Recombine chroma (luminance mode) and clip to [0,1]."""
    if cfg.color_mode == "luminance" and b.ndim == 3:
        out = yiq_to_rgb(torch.cat([bp[..., None], yiq_b[..., 1:]], dim=-1))
    else:
        out = bp
    return out.clamp(0.0, 1.0)


def create_image_analogy(
    a,
    ap,
    b,
    cfg: Optional[SynthConfig] = None,
    return_aux: bool = False,
    resume: Optional[LevelState] = None,
):
    """Synthesize B' such that A : A' :: B : B'.

    `a`, `ap`, `b`: float arrays or tensors in [0,1], (H,W,3) RGB or
    (H,W) gray; `a` and `ap` share a shape.  Everything runs on
    `cfg.device`.  Returns B' shaped like `b` as a tensor on that device
    (or {"bp", "nnf", "dist"} with per-level lists when `return_aux`).

    `resume`: the converged state of level L (`load_level_state`); the
    run then starts at level L-1 from it, as the reference's
    `resume_from` does.
    """
    cfg = cfg or SynthConfig()
    if cfg.save_level_artifacts:
        raise NotImplementedError(
            "save_level_artifacts (checkpoint writing) is not ported yet"
        )
    dev = resolve_device(cfg)

    def as_t(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    a, ap, b = as_t(a), as_t(ap), as_t(b)
    if a.shape != ap.shape:
        raise ValueError(f"A {tuple(a.shape)} and A' {tuple(ap.shape)} "
                         "must match")
    levels = cfg.clamp_levels(tuple(a.shape[:2]), tuple(b.shape[:2]))
    pyr = prologue(a, ap, b, cfg, levels)
    aux: Dict[str, List] = {"nnf": [None] * levels, "dist": [None] * levels}

    nnf = bp = None
    start = levels - 1
    if resume is not None:
        if not 0 <= resume.level < levels:
            raise ValueError(f"resume level {resume.level} outside "
                             f"[0, {levels})")
        start = resume.level - 1
        nnf, bp = resume.nnf.to(dev), resume.bp.to(dev)
        aux["nnf"][resume.level] = nnf
        aux["dist"][resume.level] = resume.dist.to(dev)
    for level in range(start, -1, -1):
        nnf, dist, bp = run_level(cfg, level, levels, pyr, nnf, bp)
        if return_aux:
            aux["nnf"][level] = nnf
            aux["dist"][level] = dist
    out = _finalize(bp, pyr[5], b, cfg)
    if return_aux:
        return {"bp": out, "nnf": aux["nnf"], "dist": aux["dist"]}
    return out

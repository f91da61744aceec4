"""Batched frames against one shared style pair: BASELINE config 5.

`synthesize_batch` synthesizes B' for a stack of frames (video frames,
or unrelated requests) against one (A, A') pair.  Per pyramid level the
A side (features, PCA basis, the tile path's A planes) is built once and
shared by every resident frame; the frames' B side carries a leading
frame axis through the single-image runner's level body
(`models/analogy.py` `prologue`, `run_level`, `make_em_step`).
Features, the merge, the polish and the kappa pass run frame by frame,
and the tile path's K1 sweeps every resident frame in one launch.

Outputs do not depend on the chunking (`frames_per_step`): the luminance
remap uses the whole stack's statistics, and every random draw of frame
i derives from (seed, level, em, slot, i) with i its global index in the
stack (`frame_indices` overrides it).  Checkpoints use the single-image
writer with the reference's batch fingerprint and `frames_{i:05d}`
chunk subdirectories, so either package resumes the other's.

Dropped from the reference, as TPU or not-yet-ported mechanics:
  - the device mesh, `NamedSharding` and the padding of the frame count
    to the mesh's grain (one device pads nothing; multi-device runs are
    ROADMAP Queue 1 step 14), so there is no `mesh` argument;
  - the serving tier's executable persist hook (`_PersistWrap`, step 13);
  - `fa_external`, `fuse`, `_SAFE_EXEC_DIST_ELEMS` and the forcing of
    brute runs to one frame per step: TPU execution-size rules, dropped
    as the single-image runner drops them (outputs do not depend on the
    chunking, so no result changes);
  - the per-shard completion walls of the level spans (one device).
The reference's telemetry and faults are kept: `progress` gets the
`prologue` span, the `run_plan` mark and one `level` span a level with
its `em_iter` children (one device sync a level when enabled), and the
`xfer`, `level`, `kernel` and `ckpt` fault points fire where the
reference's do.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import SynthConfig
from ..models.analogy import (
    _finalize,
    _save_level,
    level_energy,
    nnf_host,
    plan_frames,
    prologue,
    record_level_span,
    record_prologue,
    resolve_device,
    resume_prologue,
    run_level,
)
from ..ops.color import rgb_to_yiq
from ..ops.remap import luminance_stats
from ..runtime.faults import fire as _fault_fire
from ..telemetry.spans import as_tracer
from ..utils.io import load_image
from ..utils.profiling import scope


def _as_tensor(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def stack_stats(frames: torch.Tensor, cfg: SynthConfig):
    """The whole stack's luminance (mean, std), which every chunk's remap
    uses, or None when the config does not remap."""
    if cfg.color_mode != "luminance" or not cfg.luminance_remap:
        return None
    y_all = rgb_to_yiq(frames)[..., 0] if frames.ndim == 4 else frames
    return luminance_stats(y_all)


def _finalize_batch(bp, yiq_b, frames, cfg: SynthConfig):
    """`_finalize` over the frame axis: chroma back (luminance mode, rgb
    frames), clipped to [0, 1]."""
    if cfg.color_mode == "luminance" and frames.ndim == 4:
        return torch.stack([_finalize(bp[i], yiq_b[i], frames[i], cfg)
                            for i in range(bp.shape[0])])
    return bp.clamp(0.0, 1.0)


def _batch_fingerprint_shape(frames, n_stack: int, offset: int,
                             frame_indices=None) -> tuple:
    """The reference's checkpoint identity of a batch (chunk): its frame
    stack's shape, the whole stack's length and the chunk's offset, and
    the overridden frame indices when given."""
    shape = tuple(int(s) for s in frames.shape) + (int(n_stack), int(offset))
    if frame_indices is not None:
        shape += tuple(int(i) for i in frame_indices)
    return shape


def synthesize_batch(
    a,
    ap,
    frames,
    cfg: Optional[SynthConfig] = None,
    frames_per_step: Optional[int] = None,
    resume_from: Optional[str] = None,
    resume_strict: bool = False,
    frame_indices=None,
    return_nnf: bool = False,
    progress=None,
    _b_stats=None,
    _frame_offset: int = 0,
    _n_stack: Optional[int] = None,
):
    """B' for every frame of `frames` ((F, H, W, 3) or (F, H, W)) against
    the shared style pair (a, ap), on `cfg.device`; returns the stacked
    B' as a tensor shaped like `frames`, or (B', nnf) with `return_nnf`,
    nnf the finest level's converged fields as one host (F, H, W, 2)
    integer array (the video's warm-start seed).

    `frames_per_step` bounds the resident frames: the stack runs in
    chunks of that many frames, a ragged last chunk padded with its last
    frame (trimmed from the output).  Outputs do not depend on it (the
    remap uses the whole stack's statistics, frame i's draws its global
    index).  `frame_indices` overrides each frame's random identity:
    `[0] * F` gives every frame the streams of a one-frame run, so each
    output is independent of its batch's other frames.

    `cfg.save_level_artifacts` receives every level's whole-batch state
    (`frames_{i:05d}` subdirectories per chunk); `resume_from` restarts
    from such a directory, written by either package, with the
    reference's fingerprint ((F, H, W[, C], whole-stack length, chunk
    offset[, frame indices])).  `resume_strict` raises on an unusable
    one.  `progress`: a ProgressWriter or `telemetry.Tracer` (module
    docstring).  `_b_stats`, `_frame_offset` and `_n_stack` carry the
    whole stack's statistics, the chunk's offset and the stack's length
    into the chunks."""
    cfg = cfg or SynthConfig()
    tracer = as_tracer(progress)
    dev = resolve_device(cfg)
    if frames_per_step is not None and frames_per_step < 1:
        raise ValueError("frames_per_step must be >= 1")
    frames = _as_tensor(frames, dev)
    if frames.ndim not in (3, 4):
        raise ValueError(
            f"frames has shape {tuple(frames.shape)}; expected "
            "(F, H, W[, C])"
        )
    n = frames.shape[0]
    if frame_indices is not None:
        frame_indices = [int(i) for i in frame_indices]
        if len(frame_indices) != n:
            raise ValueError(f"frame_indices has {len(frame_indices)} "
                             f"entries for {n} frames")
    n_stack = _n_stack if _n_stack is not None else n
    if _b_stats is None:
        _b_stats = stack_stats(frames, cfg)
    if frames_per_step and frames_per_step < n:
        outs, nnfs = [], []
        for i in range(0, n, frames_per_step):
            chunk = frames[i : i + frames_per_step]
            n_chunk = chunk.shape[0]
            if n_chunk < frames_per_step:
                chunk = torch.cat(
                    [chunk] + [chunk[-1:]] * (frames_per_step - n_chunk))
            idx = None
            if frame_indices is not None:
                idx = frame_indices[i : i + frames_per_step]
                idx = idx + [idx[-1]] * (frames_per_step - len(idx))
            chunk_cfg = cfg
            if cfg.save_level_artifacts:
                chunk_cfg = dataclasses.replace(
                    cfg, save_level_artifacts=os.path.join(
                        cfg.save_level_artifacts, f"frames_{i:05d}"))
            res = synthesize_batch(
                a, ap, chunk, chunk_cfg,
                resume_from=(os.path.join(resume_from, f"frames_{i:05d}")
                             if resume_from else None),
                resume_strict=resume_strict, frame_indices=idx,
                return_nnf=return_nnf, progress=tracer, _b_stats=_b_stats,
                _frame_offset=i, _n_stack=n,
            )
            if return_nnf:
                res, chunk_nnf = res
                nnfs.append(chunk_nnf[:n_chunk])
            outs.append(res[:n_chunk])
        out = torch.cat(outs)
        return (out, np.concatenate(nnfs)) if return_nnf else out

    # The frame stack's (chunk's) transfer point.
    _fault_fire("xfer", 0)
    a, ap = _as_tensor(a, dev), _as_tensor(ap, dev)
    levels = cfg.clamp_levels(tuple(a.shape[:2]), tuple(frames.shape[1:3]))
    frame_idx = (list(frame_indices) if frame_indices is not None
                 else list(range(_frame_offset, _frame_offset + n)))
    fp_shape = _batch_fingerprint_shape(frames, n_stack, _frame_offset,
                                        frame_indices)
    start = levels - 1
    nnf = bp = None
    resumed = resume_prologue(resume_from, levels, cfg, fp_shape,
                              strict=resume_strict, progress=tracer)
    if resumed is not None:
        start, nnf, bp, _ = resumed
        nnf = torch.as_tensor(nnf, device=dev).long()
        bp = _as_tensor(bp, dev)
        if start < 0:
            # Every level was checkpointed: only the chroma is needed.
            yiq_b = (rgb_to_yiq(frames) if cfg.color_mode == "luminance"
                     and frames.ndim == 4 else None)
            out = _finalize_batch(bp, yiq_b, frames, cfg)
            return (out, nnf_host(nnf)) if return_nnf else out

    prologue_t0 = time.perf_counter()
    with scope("tlm_prologue"):
        pyr = prologue(a, ap, frames, cfg, levels, _b_stats)
    record_prologue(tracer, pyr[4], levels, prologue_t0, cfg=cfg,
                    a_hw=tuple(a.shape[:2]), runner="batch")
    for level in range(start, -1, -1):
        _fault_fire("level", level)
        level_t0 = time.perf_counter()
        plan = plan_frames(cfg, level, levels, pyr, nnf, brute_lean=False)
        _fault_fire("kernel", level)
        nnf, dist, bp = run_level(cfg, level, levels, pyr, nnf, bp, plan,
                                  frame_idx)
        if tracer.enabled:
            h, w = pyr[2][level].shape[1:3]
            record_level_span(tracer, cfg, level_t0, level, h, w,
                              level_energy(dist))
        if cfg.save_level_artifacts:
            _save_level(cfg.save_level_artifacts, level, nnf, dist, bp, cfg,
                        fp_shape)
    out = _finalize_batch(bp, pyr[5], frames, cfg)
    return (out, nnf_host(nnf)) if return_nnf else out


# ---------------------------------------------------------------------------
# Frame ingest: per-frame fault isolation, the batch's majority shape.


def ingest_frame_dir(path: str, *, strict: bool = False):
    """A directory of frames (.png, .jpg, .jpeg, sorted by name), each
    loaded on its own: an unreadable frame is skipped and recorded.
    Returns (frames (F, H, W[, 3]) float32, names, failures), failures
    a list of {"path", "reason"}.  `strict=True` raises on the first
    failure; no loadable frame raises regardless."""
    names = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    decoded, failures = [], []
    for name in names:
        fpath = os.path.join(path, name)
        try:
            img = load_image(fpath)
        except Exception as e:  # noqa: BLE001 - isolate, record, go on
            if strict:
                raise RuntimeError(
                    f"batch ingest: frame {fpath!r} failed ({e}) and "
                    "--strict-frames is set"
                ) from e
            failures.append({"path": fpath,
                             "reason": f"{type(e).__name__}: {e}"})
            continue
        decoded.append((name, fpath, img))
    if not decoded:
        raise RuntimeError(
            f"batch ingest: no loadable frames in {path!r} "
            f"({len(failures)} failed, {len(names)} candidates)"
        )
    stack, ok_names = _majority_shape_filter(
        decoded, strict, failures, "--strict-frames is set")
    return stack, ok_names, failures


def _majority_shape_filter(decoded, strict, failures, strict_hint):
    """Keep the frames of the batch's majority shape (ties: the first
    seen), so a stray odd-sized frame is the one skipped.  `decoded` is
    (label, ident, img) triples; failures name `ident`."""
    counts: dict = {}
    for _name, _ident, img in decoded:
        counts[img.shape] = counts.get(img.shape, 0) + 1
    ref_shape = max(counts, key=lambda s: counts[s])
    loaded, ok_names = [], []
    for name, ident, img in decoded:
        if img.shape != ref_shape:
            reason = (f"ValueError: frame shape {img.shape} != the batch's "
                      f"majority shape {ref_shape}")
            if strict:
                raise RuntimeError(f"batch ingest: frame {ident!r} failed "
                                   f"({reason}) and {strict_hint}")
            failures.append({"path": ident, "reason": reason})
            continue
        loaded.append(img)
        ok_names.append(name)
    return np.stack(loaded), ok_names


def ingest_frames(arrays, *, strict: bool = False):
    """`ingest_frame_dir` for in-memory frames: a sequence of (H, W[, C])
    arrays, or one stacked (F, H, W[, C]) array.  A non-array entry, a
    shape that is not 2-D or 3-D with 1 or 3 channels, or a frame off
    the majority shape is skipped with a {"path": "frames[i]", "reason"}
    record (`strict=True` raises).  Returns (frames float32, names,
    failures); no usable frame raises."""
    if isinstance(arrays, np.ndarray) and arrays.ndim in (3, 4):
        arrays = list(arrays) if arrays.ndim == 4 else [arrays]
    decoded, failures = [], []
    for i, arr in enumerate(arrays):
        label = f"frames[{i}]"
        try:
            img = np.asarray(arr, dtype=np.float32)
            if img.ndim not in (2, 3) or min(img.shape[:2]) < 1:
                raise ValueError(f"frame array has shape {img.shape}, "
                                 "expected (H, W) or (H, W, C)")
            if img.ndim == 3 and img.shape[2] not in (1, 3):
                raise ValueError(f"frame array has {img.shape[2]} "
                                 "channels, expected 1 or 3")
        except Exception as e:  # noqa: BLE001 - isolate, record, go on
            if strict:
                raise RuntimeError(
                    f"batch ingest: frame {label!r} failed ({e}) and "
                    "strict ingest is set"
                ) from e
            failures.append({"path": label,
                             "reason": f"{type(e).__name__}: {e}"})
            continue
        decoded.append((label, label, img))
    if not decoded:
        raise RuntimeError(f"batch ingest: no usable in-memory frames "
                           f"({len(failures)} failed)")
    stack, ok_names = _majority_shape_filter(decoded, strict, failures,
                                             "strict ingest is set")
    return stack, ok_names, failures

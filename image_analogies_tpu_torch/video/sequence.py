"""Video analogies: temporal synthesis over the batch runner.

Frames of one video share a style pair, and consecutive frames of real
video are nearly identical, so the batch runner, which starts every
frame from a random field, pays the full pyramid schedule for work that
barely changes.  Three mechanisms sit on the runners' level body
(`models/analogy.run_level`), which they call with other state:

1. **Warm start** (`IA_VIDEO_WARM=on|off`, `set_warm_mode`): every
   pyramid level of frame t starts from frame t-1's converged (field,
   B') at that level, through `_level_state_glue`'s "direct" arm, in
   place of the random field and the upsample chain.  "off" runs the
   whole sequence through `synthesize_batch(frames_per_step=1)`.
2. **The temporal term** (`cfg.tau`): warm frames pass frame t-1's
   field at every level to the matcher as its `temporal` anchor, and
   PatchMatch candidates pay `temporal_penalty_fn` for diverging from
   it (the per-pixel sweeps; `_video_level`).  With tau == 0 no level
   reaches that path.
3. **Delta scheduling** (`warm_schedule`): a warm frame runs a shorter
   (pm_iters, em_iters) schedule sized by the change between it and the
   frame that seeds it (`frame_delta`), quantized to `_SCALE_BUCKETS`.
   The modeled cost of the schedule actually run, against the cold one
   (`level_eta_cost_units`), is the stream's `run_units` / `cold_units`.

Telemetry as in the reference: `progress` gets each frame's
`prologue` span, `run_plan` mark and `level` spans; the registry counts
streams and frames (`ia_video_streams_total`, `ia_video_frames_total
{mode}`), books each warm frame's sweeps against its cold equivalent
(`_book_warm_frame`: `ia_warm_start_frames_total`,
`ia_warm_start_sweeps_total{mode}`) and ends with the `ia_video_flicker`
gauge; the `xfer`, `level`, `kernel` and `ckpt` fault points fire where
the reference's do.

With the seam off, a `mesh` (parallel/mesh.py, "batch" axis; every
rank calls with the same inputs) goes to the batch runner, whose
one-frame chunks then pad to the ranks as the reference's do; the warm
path runs its frames in turn on every rank, as the reference's runs
them on one device.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import SynthConfig
from ..models.analogy import (
    _save_level,
    level_energy,
    level_eta_cost_units,
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
from ..telemetry.metrics import get_registry
from ..telemetry.spans import as_tracer, scope
from ..parallel.batch import (
    _as_tensor,
    _finalize_batch,
    stack_stats,
    synthesize_batch,
)


# ---------------------------------------------------------------------------
# Warm-start seam.

_WARM_MODES = ("on", "off")
_WARM_MODE = os.environ.get("IA_VIDEO_WARM", "on")


def warm_mode() -> str:
    return _WARM_MODE


def warm_enabled() -> bool:
    return _WARM_MODE != "off"


def set_warm_mode(mode: str) -> None:
    """Install the video warm-start mode process-wide (`IA_VIDEO_WARM`);
    it selects which runner path runs, nothing else."""
    global _WARM_MODE
    if mode not in _WARM_MODES:
        raise ValueError(
            f"video warm mode {mode!r} names neither 'on' nor 'off'"
        )
    _WARM_MODE = mode


# ---------------------------------------------------------------------------
# Temporal signals: the reference's numpy functions, as they are.

# Frame-change fraction at (or above) which a warm frame runs the FULL
# schedule.  Below it the schedule scales down linearly: a static scene
# measures delta ~0 and runs the minimum bucket.
_DELTA_FULL = 0.5
# Schedule scale is quantized to this many buckets (1/N .. N/N).
_SCALE_BUCKETS = 3


def field_delta(nnf_a, nnf_b) -> float:
    """Fraction of pixels whose mapping changed between two converged
    (..., H, W, 2) fields.  An observability metric, not the scheduler's
    signal: PatchMatch lands on one of many near-equal optima per pixel,
    so this fraction is high even on a static scene (`frame_delta` is
    the scheduler's)."""
    a = np.asarray(nnf_a)
    b = np.asarray(nnf_b)
    if a.shape != b.shape:
        return 1.0
    return float(np.mean(np.any(a != b, axis=-1)))


def frame_delta(frame_a, frame_b, eps: float = 1.0 / 255.0) -> float:
    """Fraction of pixels that changed (any channel by more than `eps`,
    one 8-bit step by default) between two input frames: the warm
    scheduler's change signal, known before the frame is synthesized."""
    a = np.asarray(frame_a, np.float32)
    b = np.asarray(frame_b, np.float32)
    if a.shape != b.shape:
        return 1.0
    diff = np.abs(a - b) > eps
    if diff.ndim == 3:
        diff = np.any(diff, axis=-1)
    return float(np.mean(diff))


def warm_schedule(cfg: SynthConfig, delta: float):
    """(pm_iters, em_iters) for a warm frame that measured change
    fraction `delta` against the frame seeding it: linear in delta up to
    `_DELTA_FULL`, quantized to `_SCALE_BUCKETS` levels, floored at two
    PM sweeps (or cfg.pm_iters if fewer) and one EM step."""
    frac = min(1.0, max(0.0, float(delta)) / _DELTA_FULL)
    bucket = max(1, int(math.ceil(frac * _SCALE_BUCKETS)))
    scale = bucket / float(_SCALE_BUCKETS)
    pm_floor = min(2, cfg.pm_iters)
    pm_w = max(pm_floor, int(round(cfg.pm_iters * scale)))
    em_w = max(1, int(round(cfg.em_iters * scale)))
    return pm_w, em_w


def flicker_metric(outputs) -> float:
    """Mean per-pixel temporal delta of the stylized output: the mean
    over consecutive frame pairs of mean |out_t - out_{t-1}|; 0.0 for
    sequences shorter than 2."""
    out = np.asarray(outputs, np.float32)
    if out.shape[0] < 2:
        return 0.0
    return float(np.mean(np.abs(out[1:] - out[:-1])))


# ---------------------------------------------------------------------------
# The stream.


def _video_level(cfg: SynthConfig, level: int, levels: int, pyr, nnf, bp,
                 frame_idx, plan, prev_kind: str, temporal):
    """The temporal level: the level body with the previous frame's
    field at this level as every EM step's `temporal` anchor (the
    per-pixel sweeps with `temporal_penalty_fn`).  Only warm frames with
    tau > 0 reach it."""
    return run_level(cfg, level, levels, pyr, nnf, bp, plan, frame_idx,
                     prev_kind=prev_kind, temporal=temporal)


def _ckpt_bps(resume_dir: Optional[str], levels: int):
    """Per-level B' of a resumed frame's checkpoint tree ({level: array}):
    the resume state carries the finest B' only, the next frame's warm
    seed needs every level's.  Best-effort: a missing or unreadable
    level is left out."""
    bps = {}
    if not resume_dir:
        return bps
    for level in range(levels):
        path = os.path.join(resume_dir, f"level_{level}.npz")
        try:
            with np.load(path) as z:
                bps[level] = np.asarray(z["bp"])
        except Exception:  # noqa: BLE001 - the seed is best-effort
            continue
    return bps


def _pyr_shapes(hw, levels: int):
    """(h, w) of every pyramid level, finest first, for pricing a frame
    whose pyramids were not built (fully resumed)."""
    h, w = int(hw[0]), int(hw[1])
    return [[max(1, h // (2 ** lv)), max(1, w // (2 ** lv))]
            for lv in range(levels)]


def _book_warm_frame(cfg: SynthConfig, run_cfg: SynthConfig,
                     levels: int, registry=None) -> None:
    """Ledger one warm-started frame: the frame count, and its scheduled
    PM sweeps against the cold equivalent, each priced as levels x
    em_iters x pm_iters (at the warm schedule and at the base config)."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "ia_warm_start_frames_total",
        "video frames synthesized from a warm-start seed",
    ).inc()
    sweeps = reg.counter(
        "ia_warm_start_sweeps_total",
        "scheduled PM sweeps on warm-started frames vs their cold "
        "equivalent",
    )
    sweeps.inc(float(levels * run_cfg.em_iters * run_cfg.pm_iters),
               labels={"mode": "warm"})
    sweeps.inc(float(levels * cfg.em_iters * cfg.pm_iters),
               labels={"mode": "cold_equiv"})


def _set_flicker(out) -> float:
    """The output's flicker, also set as the `ia_video_flicker` gauge of
    the process-default registry."""
    flick = flicker_metric(_host(out))
    get_registry().gauge(
        "ia_video_flicker",
        "mean per-pixel temporal delta of the stylized output",
    ).set(flick)
    return flick


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VideoStream:
    """Warm-start synthesis frame by frame: one stream, one video.

    Each `step(frame)` runs one frame through the runners' level
    body on a one-frame stack.  Frame 0 runs the full cold schedule and
    equals the batch runner's frame 0 (same prologue, whole-stack remap
    statistics when given, frame-index draws).  Later frames start warm
    from the carried state when the seam is on.

    The style's luminance statistics freeze on the `b_stats` given (the
    whole stack's, from `synthesize_video`) or else on the first frame's
    own: every frame is remapped against one normalization, or the style
    itself would flicker.  The carried state lives on the run's device.
    `progress` (a ProgressWriter or tracer) gets every frame's spans;
    `registry` receives the video counters (None: the process default
    at booking time).
    """

    def __init__(self, a, ap, cfg: Optional[SynthConfig] = None,
                 b_stats=None, n_stack: Optional[int] = None,
                 progress=None, registry=None):
        self.cfg = cfg or SynthConfig()
        self.tracer = as_tracer(progress)
        self.registry = registry
        self.dev = resolve_device(self.cfg)
        self.a = _as_tensor(a, self.dev)
        self.ap = _as_tensor(ap, self.dev)
        self.b_stats = b_stats
        self.n_stack = n_stack
        self.t = 0
        self._fields = None       # {level: (1, h, w, 2)} converged fields
        self._bps = None          # {level: (1, h, w[, C])} converged B'
        self._prev_frame = None   # frame t-1's input (the delta signal)
        self.finest_history = []  # per-frame (h, w, 2) finest fields
        self.deltas = []          # measured delta per frame (None: cold)
        self.schedules = []       # (pm_iters, em_iters) run per frame
        self.warm_frames = 0
        self.run_units = 0.0      # modeled units of the schedules run
        self.cold_units = 0.0     # modeled units of the cold equivalent
        # Serving request id per frame (None outside the daemon): which
        # request produced stream frame t, for the trace join.
        self.request_ids = []

    def step(self, frame, *, resume_root: Optional[str] = None,
             resume_strict: bool = False,
             request_id: Optional[str] = None):
        """Synthesize the next frame; returns the stylized (H, W[, 3])
        tensor.  `resume_root`: a prior run's checkpoint root; this frame
        resumes from its `frames_{t:05d}` subdirectory (the batch
        runner's layout, so warm-off and warm-on runs share cold frames'
        checkpoints).  `request_id`: the serving request driving this
        frame, recorded on `self.request_ids`."""
        self.request_ids.append(request_id)
        cfg = self.cfg
        t = self.t
        frame_np = _host(frame).astype(np.float32)
        can_warm = (warm_enabled() and t > 0 and self._fields is not None
                    and bool(self._bps))
        if can_warm:
            delta = (1.0 if self._prev_frame is None
                     else frame_delta(frame_np, self._prev_frame))
            pm_w, em_w = warm_schedule(cfg, delta)
            run_cfg = dataclasses.replace(cfg, pm_iters=pm_w, em_iters=em_w)
            self.deltas.append(delta)
        else:
            run_cfg = cfg
            self.deltas.append(None)
        self.schedules.append((run_cfg.pm_iters, run_cfg.em_iters))

        out, fields, bps, shapes, seeded, ran = self._run_frame(
            frame, run_cfg, can_warm, resume_root, resume_strict)
        reg = self.registry if self.registry is not None else get_registry()
        if t == 0:
            reg.counter(
                "ia_video_streams_total",
                "video streams started (each stream's head frame is "
                "cold)",
            ).inc()
        if ran:
            # A fully resumed frame scheduled no synthesis: the ledger
            # records this run's work.
            reg.counter(
                "ia_video_frames_total",
                "video frames synthesized, by schedule mode",
            ).inc(labels={"mode": "warm" if seeded else "cold"})
            a_hw = tuple(self.a.shape[:2])
            self.run_units += sum(level_eta_cost_units(
                run_cfg, shapes, a_hw).values())
            self.cold_units += sum(level_eta_cost_units(
                cfg, shapes, a_hw).values())
        if seeded:
            self.warm_frames += 1
            _book_warm_frame(cfg, run_cfg, len(shapes), reg)
        finest = fields.get(0)
        self._prev_frame = frame_np
        if finest is not None:
            self.finest_history.append(finest[0])
        self._fields = fields
        self._bps = bps
        self.t += 1
        return out

    # -- carried state across processes -----------------------------------

    def save_state(self, state_dir: str) -> dict:
        """Snapshot the carried warm state (per-level converged fields and
        B', the previous input frame, the frame counter, the frozen style
        statistics) under `state_dir`, in the reference's file layout
        (`stream_state.npz`, `stream_meta.json`), each written to a
        temporary file and renamed."""
        import json

        os.makedirs(state_dir, exist_ok=True)
        arrays = {}
        levels = sorted((self._fields or {}).keys())
        for lv in levels:
            arrays[f"field_{lv}"] = _host(self._fields[lv])
            if self._bps and lv in self._bps:
                arrays[f"bp_{lv}"] = _host(self._bps[lv])
        if self._prev_frame is not None:
            arrays["prev_frame"] = np.asarray(self._prev_frame)
        if self.b_stats is not None:
            arrays["b_stats"] = np.asarray([float(s) for s in self.b_stats])
        npz_path = os.path.join(state_dir, "stream_state.npz")
        tmp = npz_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, npz_path)
        meta = {"t": int(self.t), "levels": levels,
                "has_b_stats": self.b_stats is not None}
        meta_path = os.path.join(state_dir, "stream_meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, meta_path)
        return meta

    def restore_state(self, state_dir: str) -> bool:
        """Load a `save_state` snapshot into this (fresh) stream.
        Best-effort: False, and the stream unchanged (its next frame runs
        cold), when the snapshot is missing or unreadable."""
        import json

        npz_path = os.path.join(state_dir, "stream_state.npz")
        meta_path = os.path.join(state_dir, "stream_meta.json")
        try:
            with open(meta_path, "r", encoding="utf-8") as fh:
                meta = json.load(fh)
            fields, bps = {}, {}
            with np.load(npz_path) as z:
                for lv in meta.get("levels") or []:
                    lv = int(lv)
                    fields[lv] = np.asarray(z[f"field_{lv}"])
                    if f"bp_{lv}" in z:
                        bps[lv] = np.asarray(z[f"bp_{lv}"])
                prev = (np.asarray(z["prev_frame"])
                        if "prev_frame" in z else None)
                if meta.get("has_b_stats") and "b_stats" in z:
                    self.b_stats = tuple(np.asarray(z["b_stats"]).tolist())
        except Exception:  # noqa: BLE001 - the snapshot is best-effort
            return False
        if not fields:
            return False
        self._fields = fields
        self._bps = bps
        self._prev_frame = prev
        self.t = int(meta.get("t", 0))
        return True

    # -- one frame through the batch level body ----------------------------

    def _run_frame(self, frame, run_cfg: SynthConfig, warm: bool,
                   resume_root, resume_strict):
        cfg, t, dev, tracer = self.cfg, self.t, self.dev, self.tracer
        # This frame's transfer point.
        _fault_fire("xfer", 0)
        frames = _as_tensor(frame, dev)
        if frames.ndim == 2 or (frames.ndim == 3
                                and frames.shape[-1] in (1, 3)):
            frames = frames[None]
        if self.b_stats is None and cfg.color_mode == "luminance" \
                and cfg.luminance_remap:
            y = rgb_to_yiq(frames)[..., 0] if frames.ndim == 4 else frames
            self.b_stats = luminance_stats(y)

        if cfg.save_level_artifacts:
            run_cfg = dataclasses.replace(
                run_cfg, save_level_artifacts=os.path.join(
                    cfg.save_level_artifacts, f"frames_{t:05d}"))
        resume_dir = (os.path.join(resume_root, f"frames_{t:05d}")
                      if resume_root else None)
        levels = cfg.clamp_levels(tuple(self.a.shape[:2]),
                                  tuple(frames.shape[1:3]))
        frame_idx = [t]
        # The batch runner's fingerprint of a one-frame chunk, so cold
        # frames' checkpoints serve warm-off and warm-on runs alike (warm
        # frames stamp their shortened schedule); a stream of unknown
        # length identifies as t + 1 frames long.
        n_stack = self.n_stack if self.n_stack is not None else t + 1
        fp_shape = (1,) + tuple(int(s) for s in frames.shape[1:]) \
            + (n_stack, t)

        start_level = levels - 1
        bp = nnf = None
        aux = {}
        resumed = resume_prologue(resume_dir, levels, run_cfg, fp_shape,
                                  strict=resume_strict, progress=tracer)
        if resumed is not None:
            start_level, nnf, bp, aux = resumed
            nnf = torch.as_tensor(nnf, device=dev).long()
            bp = _as_tensor(bp, dev)
            if start_level < 0:
                # Fully checkpointed: finalize; the carried state comes
                # from the checkpoint's per-level fields and B'.
                yiq_b = (rgb_to_yiq(frames) if cfg.color_mode == "luminance"
                         and frames.ndim == 4 else None)
                out = _finalize_batch(bp, yiq_b, frames, run_cfg)
                fields = {lv: np.asarray(n)[:1] for lv, (n, _d) in aux.items()}
                return (out[0], fields, _ckpt_bps(resume_dir, levels),
                        _pyr_shapes(frames.shape[1:3], levels), False, False)

        prologue_t0 = time.perf_counter()
        with scope("tlm_prologue"):
            pyr = prologue(self.a, self.ap, frames, cfg, levels,
                           self.b_stats)
        record_prologue(tracer, pyr[4], levels, prologue_t0, cfg=run_cfg,
                        a_hw=tuple(self.a.shape[:2]), runner="video")
        _, _, pyr_src_b, _, pyr_raw_b, yiq_b = pyr
        seed_fields = self._fields if warm else None
        seed_bps = self._bps if warm else None
        fields, bps = {}, {}
        seeded = False
        shapes = [[int(s) for s in pyr_raw_b[lv].shape[1:3]]
                  for lv in range(levels)]

        def seed_of(seeds, level, hw):
            """`seeds[level]` on the device when its (h, w) is `hw`."""
            if seeds is None or level not in seeds:
                return None
            x = seeds[level]
            if tuple(x.shape[1:3]) != tuple(hw):
                return None
            return torch.as_tensor(x, device=dev)

        tracer.bind_device(dev)
        for level in range(start_level, -1, -1):
            _fault_fire("level", level)
            with tracer.span("level", level=level) as lvl_span:
                h, w = pyr_src_b[level].shape[1:3]
                has_coarse = level < levels - 1
                plan = plan_frames(run_cfg, level, levels, pyr, nnf,
                                   brute_lean=False)
                prev_kind = plan.prev_kind
                field = seed_of(seed_fields, level, (h, w))
                bp_seed = seed_of(seed_bps, level, (h, w))
                bp_coarse = (seed_of(seed_bps, level + 1,
                                     pyr_src_b[level + 1].shape[1:3])
                             if has_coarse else None)
                if (warm and resumed is None and field is not None
                        and bp_seed is not None and not plan.lean
                        and (not has_coarse or bp_coarse is not None)):
                    # Warm seed: the previous frame's converged state at THIS
                    # level in place of the init ("direct" glue); below the
                    # coarsest level the glue also takes the coarse B'.
                    prev_kind = "direct"
                    nnf = field.long()
                    bp = (bp_seed.float(), bp_coarse.float()) if has_coarse \
                        else bp_seed.float()
                    seeded = True
                use_temporal = (
                    warm and cfg.tau > 0.0 and cfg.matcher == "patchmatch"
                    and not plan.lean and field is not None
                )
                _fault_fire("kernel", level)
                if use_temporal:
                    nnf, dist, bp = _video_level(
                        run_cfg, level, levels, pyr, nnf, bp, frame_idx, plan,
                        prev_kind, field.long())
                else:
                    nnf, dist, bp = run_level(
                        run_cfg, level, levels, pyr, nnf, bp, plan, frame_idx,
                        prev_kind=prev_kind)
                if tracer.enabled:
                    record_level_span(tracer, run_cfg, lvl_span, level, h,
                                      w, level_energy(dist))
            fields[level] = (torch.stack(nnf, dim=-1)
                             if isinstance(nnf, tuple) else nnf)
            bps[level] = bp
            if run_cfg.save_level_artifacts:
                _save_level(run_cfg.save_level_artifacts, level, nnf, dist,
                            bp, run_cfg, fp_shape)

        # Partial resume: the checkpointed coarser levels' (field, B')
        # come from the resume state and the checkpoint files, so the
        # next frame still has every level's seed.
        for lv, (a_nnf, _d) in aux.items():
            fields.setdefault(lv, np.asarray(a_nnf)[:1])
        if resume_dir:
            for lv, b in _ckpt_bps(resume_dir, levels).items():
                bps.setdefault(lv, b)
        out = _finalize_batch(bp, yiq_b, frames, run_cfg)
        return out[0], fields, bps, shapes, seeded, True


def synthesize_video(
    a,
    ap,
    frames,
    cfg: Optional[SynthConfig] = None,
    resume_from: Optional[str] = None,
    resume_strict: bool = False,
    return_aux: bool = False,
    progress=None,
    mesh=None,
):
    """Stylized B' for a frame SEQUENCE ((F, H, W[, 3])) against one style
    pair, warm-started frame to frame (module docstring), on
    `cfg.device`.  Returns the stacked outputs as a tensor shaped like
    `frames`; `return_aux=True` returns (outputs, aux) with the run's
    temporal accounting: "mode", per-frame finest "fields" (host
    array), measured "deltas", the "schedules" run, "flicker",
    "warm_frames", and the modeled "run_units" / "cold_units" (the
    warm-cost ratio's numerator and denominator).

    With the seam off the sequence runs through
    `synthesize_batch(frames_per_step=1)`, every frame cold.  Both modes
    write and resume the same `frames_{t:05d}` checkpoint layout
    (`cfg.save_level_artifacts`, `resume_from`).  `progress`: a
    ProgressWriter or `telemetry.Tracer` (module docstring).  `mesh`:
    the warm-off dispatch's batch mesh (module docstring)."""
    cfg = cfg or SynthConfig()
    dev = resolve_device(cfg)
    frames = _as_tensor(frames, dev)
    if frames.ndim not in (3, 4):
        raise ValueError(f"frames has shape {tuple(frames.shape)}; "
                         "expected (F, H, W[, C])")
    n = frames.shape[0]
    if not warm_enabled():
        res = synthesize_batch(
            a, ap, frames, cfg, frames_per_step=1, resume_from=resume_from,
            resume_strict=resume_strict, return_nnf=return_aux,
            progress=progress, mesh=mesh,
        )
        out, nnf = res if return_aux else (res, None)
        flick = _set_flicker(out)
        if not return_aux:
            return out
        return out, {
            "mode": "off",
            "fields": nnf,
            "deltas": [None] * n,
            "schedules": [(cfg.pm_iters, cfg.em_iters)] * n,
            "flicker": flick,
            "warm_frames": 0,
            "run_units": None,
            "cold_units": None,
        }

    # The batch runner's whole-stack normalization: frame 0 of a warm run
    # is then frame 0 of the batch run over the same stack.
    stream = VideoStream(a, ap, cfg=cfg, b_stats=stack_stats(frames, cfg),
                         n_stack=n, progress=progress)
    out = torch.stack([
        stream.step(frames[t], resume_root=resume_from,
                    resume_strict=resume_strict)
        for t in range(n)
    ])
    flick = _set_flicker(out)
    if not return_aux:
        return out
    return out, {
        "mode": "on",
        "fields": (np.stack([_host(f) for f in stream.finest_history])
                   if stream.finest_history else np.zeros((0,), np.int32)),
        "deltas": list(stream.deltas),
        "schedules": list(stream.schedules),
        "flicker": flick,
        "warm_frames": stream.warm_frames,
        "run_units": stream.run_units,
        "cold_units": stream.cold_units,
    }

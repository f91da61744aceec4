"""Command line of the port: `python -m image_analogies_tpu_torch.cli`.

Subcommands:
  synth     A + A' + B -> B'
  batch     A + A' + a directory of frames -> stylized frames
  video     A + A' + a frame sequence -> stylized frames, warm-started
  examples  write the procedural example assets

The flags are the reference CLI's (`image_analogies_tpu/cli.py`), with
`--device {cuda,cpu}` (default cuda; a run without a card raises unless
it asks for the CPU, and `--device cpu` never initialises CUDA).  The
kernels' build directory, `build/ia_torch_kernels/`, takes the place of
the reference's compilation cache.

Flags of parts not ported yet keep the reference's parser, so a bad
value still fails at parse time, and then stop the run with a message
naming the ROADMAP step that ports them: `--spatial`, `--sharded-a`,
`--bands`, `--n-devices` (step 14, multi-device) and `--health`,
`--metrics-port` (step 12, the run sentinel and live exporter).

`--trace-dir DIR` writes the telemetry artifacts (host_spans.json,
metrics.json, metrics.prom, flight.json) and costs one device sync a
level; `--profile DIR` writes a `torch.profiler` trace of the run
(`torch_trace.json`) and adds no sync of its own.  The two are
independent: a run may take both.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--log-level", default=None,
        choices=["debug", "info", "warning", "error", "critical"],
        help="attach a stderr handler to the image_analogies_tpu_torch "
        "logger at this level (default: leave logging unconfigured)",
    )


def _add_synth_flags(p: argparse.ArgumentParser) -> None:
    _add_common_flags(p)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--patch-size", type=int, default=5)
    p.add_argument("--coarse-patch-size", type=int, default=3)
    p.add_argument("--kappa", type=float, default=0.0)
    # choices: a matcher typo fails at parse time, before the images load.
    p.add_argument(
        "--matcher", default="patchmatch",
        choices=("brute", "patchmatch", "ann"),
        help="brute | patchmatch | ann (native C++ kd-tree on the host)",
    )
    p.add_argument(
        "--ann-eps", type=float, default=0.5,
        help="ann matcher approximation factor; 0 = exact tree search",
    )
    p.add_argument(
        "--color-mode", default="luminance", choices=["luminance", "rgb"]
    )
    p.add_argument("--steerable", action="store_true")
    p.add_argument("--no-luminance-remap", action="store_true")
    p.add_argument("--em-iters", type=int, default=3)
    p.add_argument("--pm-iters", type=int, default=6)
    p.add_argument(
        "--pca-dims", type=int, default=None,
        help="project features to this many principal components before "
        "matching (default off)",
    )
    p.add_argument(
        "--cand-dtype", default=None, choices=("bf16", "int8"),
        help="candidate-table compression: bf16 = the uncompressed tables "
        "(default), int8 = quantized sweep planes and polish rows.  Sets "
        "the process-wide mode (IA_CAND_DTYPE)",
    )
    p.add_argument(
        "--pca-prune", default=None, metavar="K:M",
        help="PCA coarse-distance pre-prune: keep the top M of each "
        "tile's candidates by K projected dims (e.g. '16:8'); 'off' "
        "disables.  Sets the process-wide mode (IA_CAND_PRUNE)",
    )
    p.add_argument(
        "--tau", type=float, default=0.0,
        help="temporal-coherence weight (video): warm frames' candidates "
        "pay tau for diverging from the previous frame's field",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--feature-bytes-budget", type=int, default=None,
        help="per-level float32 feature-table budget in bytes; levels "
        "above it take the lean path (default 2 GiB)",
    )
    p.add_argument(
        "--brute-lean-bytes", type=int, default=None,
        help="float32 feature-table bytes above which brute levels run "
        "the lean-brute oracle (default 10 GiB)",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where tensors live and kernels run (default cuda; a run "
        "without a card raises unless it asks for cpu)",
    )
    p.add_argument(
        "--pallas-mode", default="auto", choices=["auto", "off", "interpret"],
        help="tile-path selection: auto (the CUDA kernels on the card, "
        "their plain versions on the CPU) | off (per-pixel sweeps) | "
        "interpret (the plain versions on either device)",
    )
    p.add_argument("--save-level-artifacts", default=None)
    p.add_argument(
        "--resume-from", default=None, metavar="DIR",
        help="resume mid-pyramid from a --save-level-artifacts directory",
    )
    p.add_argument(
        "--strict-resume", action="store_true",
        help="error out (naming the directory and every rejection) when "
        "--resume-from holds no usable checkpoint, instead of warning and "
        "recomputing from scratch",
    )
    p.add_argument(
        "--supervise", action="store_true",
        help="run under the supervisor (runtime/supervisor.py): per-level "
        "watchdog deadlines from the cost model, retry with resume from "
        "the per-level checkpoints (save-level-artifacts is forced on), "
        "a degradation ladder, and a flight dump and exit != 0 when it "
        "gives up.  Implies instrumentation (one device sync a level)",
    )
    p.add_argument(
        "--max-retries", type=int, default=2, metavar="N",
        help="supervised mode: retries per ladder rung (default 2)",
    )
    p.add_argument(
        "--watchdog-slack", type=float, default=None, metavar="X",
        help="supervised mode: level deadline = modeled cost x calibrated "
        "rate x this slack (default 4.0)",
    )
    p.add_argument(
        "--watchdog-static-deadline", type=float, default=None,
        metavar="SECONDS",
        help="supervised mode: per-level bound before the cost model is "
        "calibrated (default 900)",
    )
    p.add_argument("--progress", default=None, help="JSONL progress path")
    p.add_argument(
        "--trace-dir", default=None, metavar="DIR",
        help="telemetry directory: the host span tree (host_spans.json), "
        "the metrics (metrics.json, metrics.prom) and the flight dump "
        "(flight.json, flushed before the process dies on SIGTERM or "
        "SIGINT).  One device sync a level",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="torch.profiler trace of the run (DIR/torch_trace.json, "
        "every kernel by name); adds no sync of its own",
    )
    p.add_argument(
        "--health", action="store_true",
        help="run sentinel (not ported yet: ROADMAP Queue 1 step 12)",
    )
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="live telemetry endpoint (not ported yet: ROADMAP Queue 1 "
        "step 12)",
    )


# Flags of parts not ported yet: (attribute, flag, the ROADMAP step).
_UNPORTED = (
    ("spatial", "--spatial", "step 14 (multi-device runners)"),
    ("sharded_a", "--sharded-a", "step 14 (multi-device runners)"),
    ("bands", "--bands", "step 14 (multi-device runners)"),
    ("n_devices", "--n-devices", "step 14 (multi-device runners)"),
    ("health", "--health", "step 12 (the run sentinel)"),
    ("metrics_port", "--metrics-port", "step 12 (the live exporter)"),
)


def _refuse_unported(args) -> None:
    """Stop before any image loads when a flag of an unported part was
    given: it is never ignored."""
    for attr, flag, step in _UNPORTED:
        value = getattr(args, attr, None)
        if value is not None and value is not False:
            raise SystemExit(
                f"{flag} is not ported to the PyTorch package yet: "
                f"ROADMAP Queue 1 {step}"
            )


def _config_from(args):
    from .config import SynthConfig

    budget = (
        {}
        if args.feature_bytes_budget is None
        else {"feature_bytes_budget": args.feature_bytes_budget}
    )
    if args.brute_lean_bytes is not None:
        budget["brute_lean_bytes"] = args.brute_lean_bytes
    return SynthConfig(
        **budget,
        levels=args.levels,
        patch_size=args.patch_size,
        coarse_patch_size=args.coarse_patch_size,
        kappa=args.kappa,
        matcher=args.matcher,
        color_mode=args.color_mode,
        steerable=args.steerable,
        luminance_remap=not args.no_luminance_remap,
        em_iters=args.em_iters,
        pm_iters=args.pm_iters,
        pca_dims=args.pca_dims,
        ann_eps=args.ann_eps,
        tau=args.tau,
        seed=args.seed,
        pallas_mode=args.pallas_mode,
        save_level_artifacts=args.save_level_artifacts,
        device=args.device,
    )


def _apply_cand_compression(args) -> None:
    """Install --cand-dtype / --pca-prune process-wide (module switches,
    not config fields); a malformed prune spec fails before the images
    load."""
    if args.cand_dtype is None and args.pca_prune is None:
        return
    from .kernels.patchmatch_tile import set_cand_compression

    try:
        set_cand_compression(args.cand_dtype, args.pca_prune)
    except ValueError as e:
        raise SystemExit(f"--cand-dtype/--pca-prune: {e}")


def _start(args):
    """What every synthesis command does first: refuse unported flags,
    install the compression modes, configure, and decide whether the run
    is instrumented (a progress stream, a telemetry directory or the
    supervisor; `--profile` alone is not).  Returns (cfg, ckpt_dir,
    ckpt_ephemeral, instrument)."""
    _refuse_unported(args)
    _apply_cand_compression(args)
    cfg = _config_from(args)
    instrument = bool(args.progress or args.trace_dir or args.supervise)
    cfg, ckpt_dir, ephemeral = _force_ckpt_dir(args, cfg)
    return cfg, ckpt_dir, ephemeral, instrument


def _session(args, progress, instrument, cfg):
    from .utils.profiling import telemetry_session

    return telemetry_session(
        args.profile, sink=progress, enabled=instrument,
        artifact_dir=args.trace_dir, cuda=cfg.device == "cuda",
    )


def cmd_synth(args) -> int:
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .models.analogy import ResumeError, create_image_analogy
    from .utils.io import load_image, save_image
    from .utils.progress import ProgressWriter

    progress = ProgressWriter(args.progress)
    a = load_image(args.a)
    ap = load_image(args.ap)
    b = load_image(args.b)
    t0 = time.perf_counter()
    with _session(args, progress, instrument, cfg) as tracer:
        # A disabled tracer: events still reach the JSONL/log stream
        # through the writer itself.
        events = tracer if tracer.enabled else progress
        events.emit("start", shape=list(b.shape), matcher=cfg.matcher)
        strict_state = {"first": True}

        def _dispatch(resume_from):
            return create_image_analogy(
                a, ap, b, cfg, progress=tracer if instrument else None,
                resume_from=resume_from,
                resume_strict=_resume_strict_for(args, resume_from,
                                                 strict_state),
            )

        if args.supervise:
            bp = _run_supervised(args, _dispatch, ckpt_dir, tracer,
                                 ckpt_ephemeral)
        else:
            try:
                bp = _dispatch(args.resume_from)
            except ResumeError as e:
                raise SystemExit(str(e))
        # On the host before the clock stops: the copy waits for the
        # device.
        bp = bp.cpu()
        events.emit("done", wall_s=round(time.perf_counter() - t0, 3))
    save_image(args.out, bp)
    print(f"wrote {args.out} ({time.perf_counter() - t0:.2f}s)")
    return 0


def _force_ckpt_dir(args, cfg):
    """Supervised mode retries from checkpoints, so it forces
    save_level_artifacts on: the user's directory, else
    `<trace-dir>/supervisor_ckpt`, else a private temporary directory
    removed after a successful run.  Returns (cfg, ckpt_dir, ephemeral),
    ckpt_dir None when not supervising."""
    if not args.supervise:
        return cfg, None, False
    import dataclasses
    import tempfile

    ephemeral = False
    ckpt_dir = cfg.save_level_artifacts
    if not ckpt_dir and args.trace_dir:
        ckpt_dir = os.path.join(args.trace_dir, "supervisor_ckpt")
    elif not ckpt_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="ia_supervisor_ckpt_")
        ephemeral = True
    return dataclasses.replace(
        cfg, save_level_artifacts=ckpt_dir
    ), ckpt_dir, ephemeral


def _resume_strict_for(args, resume_from, state) -> bool:
    """--strict-resume binds to the user's resume source on the first
    attempt only (`state` is a per-command {"first": True} consumed
    here): a supervised retry stays lenient even when its checkpoint
    directory is the user's --resume-from, because a retry's artifacts
    may be partial or (under an injected truncate) corrupt, and the
    loader's skip-and-warn is the healing path."""
    first = state.pop("first", False)
    return bool(
        first
        and args.strict_resume
        and resume_from is not None
        and resume_from == args.resume_from
    )


def _run_supervised(args, dispatch, ckpt_dir, tracer,
                    ckpt_ephemeral=False):
    """The supervised entry of synth, batch and video: run under
    `runtime.supervisor` with the default ladder, and turn a give-up
    into a non-zero exit (the flight dump is already flushed)."""
    from .models.analogy import ResumeError
    from .runtime.supervisor import (
        STATIC_DEADLINE_S,
        WATCHDOG_SLACK,
        SupervisorGaveUp,
        supervise,
    )

    try:
        result = supervise(
            dispatch,
            ckpt_dir=ckpt_dir,
            tracer=tracer,
            initial_resume=args.resume_from,
            max_retries=args.max_retries,
            watchdog_slack=(
                args.watchdog_slack if args.watchdog_slack is not None
                else WATCHDOG_SLACK
            ),
            static_deadline_s=(
                args.watchdog_static_deadline
                if args.watchdog_static_deadline is not None
                else STATIC_DEADLINE_S
            ),
        )
    except SupervisorGaveUp as e:
        # The checkpoints stay, an ephemeral directory too: they are the
        # manual-resume half of the post-mortem.
        raise SystemExit(f"supervised synthesis gave up: {e}")
    except ResumeError as e:
        raise SystemExit(str(e))
    if ckpt_ephemeral:
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return result


def _book_frame_failures(tracer, failures) -> None:
    if not (failures and tracer.enabled):
        return
    from .telemetry.metrics import get_registry

    c = get_registry().counter(
        "ia_frames_failed_total",
        "batch-ingest frames skipped for per-frame faults "
        "(unreadable/undecodable; --strict-frames aborts instead)",
    )
    for rec in failures:
        c.inc(labels={"reason": rec["reason"].split(":", 1)[0]})
    tracer.emit(
        "frame_failures",
        n=len(failures),
        frames=[rec["path"] for rec in failures],
    )


def _run_frames(args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress,
                run):
    """batch and video: the session around `run(frames, tracer,
    resume_from, strict)`, supervised or not; returns (outputs on the
    host, names, failures, t0)."""
    from .models.analogy import ResumeError
    from .parallel.batch import ingest_frame_dir
    from .utils.io import load_image

    a = load_image(args.a)
    ap = load_image(args.ap)
    frames, names, failures = ingest_frame_dir(
        args.frames, strict=args.strict_frames
    )
    t0 = time.perf_counter()
    with _session(args, progress, instrument, cfg) as tracer:
        _book_frame_failures(tracer, failures)
        strict_state = {"first": True}

        def _dispatch(resume_from):
            return run(
                a, ap, frames, tracer if instrument else None, resume_from,
                _resume_strict_for(args, resume_from, strict_state),
            )

        if args.supervise:
            bps = _run_supervised(args, _dispatch, ckpt_dir, tracer,
                                  ckpt_ephemeral)
        else:
            try:
                bps = _dispatch(args.resume_from)
            except ResumeError as e:
                raise SystemExit(str(e))
        bps = bps.cpu()
    return bps, names, failures, t0


def _write_frames(args, names, bps, failures, progress) -> None:
    """Every output frame to `--out` under its input's name, each named
    in the progress stream as it is written; then the ingest failures."""
    from .utils.io import save_image

    os.makedirs(args.out, exist_ok=True)
    for i, (name, bp) in enumerate(zip(names, bps)):
        path = os.path.join(args.out, name)
        save_image(path, bp)
        progress.emit("frame", index=i, name=name, path=path)
    for rec in failures:
        print(f"frame FAILED (skipped): {rec['path']} — {rec['reason']}")
    if failures:
        print(
            f"{len(failures)} frame(s) skipped; rerun with "
            "--strict-frames to abort on ingest errors instead"
        )


def cmd_batch(args) -> int:
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .parallel.batch import synthesize_batch
    from .utils.progress import ProgressWriter

    progress = ProgressWriter(args.progress)

    def run(a, ap, frames, prog, resume_from, strict):
        return synthesize_batch(
            a, ap, frames, cfg, frames_per_step=args.frames_per_step,
            resume_from=resume_from, resume_strict=strict, progress=prog,
        )

    bps, names, failures, t0 = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    _write_frames(args, names, bps, failures, progress)
    print(f"wrote {len(names)} frames to {args.out} "
          f"({time.perf_counter() - t0:.2f}s)")
    return 0


def cmd_video(args) -> int:
    """A frame sequence with temporal warm starts (video/): the batch
    command's ingest, telemetry and --supervise, frame-granular resume
    through the per-frame `frames_{t:05d}` checkpoint directories."""
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .utils.progress import ProgressWriter
    from .video import set_warm_mode, synthesize_video

    if args.warm:
        set_warm_mode(args.warm)
    progress = ProgressWriter(args.progress)

    def run(a, ap, frames, prog, resume_from, strict):
        return synthesize_video(
            a, ap, frames, cfg, resume_from=resume_from,
            resume_strict=strict, progress=prog,
        )

    bps, names, failures, t0 = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    _write_frames(args, names, bps, failures, progress)
    print(f"wrote {len(names)} frames to {args.out} "
          f"({time.perf_counter() - t0:.2f}s, warm={args.warm or 'on'})")
    return 0


def cmd_examples(args) -> int:
    from .utils import examples as ex
    from .utils.io import save_image

    os.makedirs(args.out, exist_ok=True)
    sets = {
        "texture_by_numbers": ex.texture_by_numbers(args.size),
        "artistic_filter": ex.artistic_filter(args.size),
        "super_resolution": ex.super_resolution(args.size),
        "texture_transfer": ex.texture_transfer(args.size),
    }
    for name, (a, ap, b) in sets.items():
        for tag, img in [("A", a), ("Ap", ap), ("B", b)]:
            save_image(os.path.join(args.out, f"{name}_{tag}.png"), img)
    a, ap, frames = ex.npr_frames(4, args.size)
    save_image(os.path.join(args.out, "npr_A.png"), a)
    save_image(os.path.join(args.out, "npr_Ap.png"), ap)
    for i, f in enumerate(frames):
        save_image(os.path.join(args.out, f"npr_frame_{i}.png"), f)
    print(f"wrote example assets to {args.out}")
    return 0


def _add_frames_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--a", required=True)
    p.add_argument("--ap", required=True)
    p.add_argument("--frames", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument(
        "--strict-frames", action="store_true",
        help="abort on the first unreadable or undecodable frame instead "
        "of skipping it with a recorded per-frame status",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="image_analogies_tpu_torch",
        description="Image Analogies (A : A' :: B : B') on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help="synthesize B' from A, A', B")
    p.add_argument("--a", required=True)
    p.add_argument("--ap", required=True)
    p.add_argument("--b", required=True)
    p.add_argument("--out", required=True)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--spatial", action="store_true",
                      help="not ported yet (ROADMAP Queue 1 step 14)")
    mode.add_argument("--sharded-a", action="store_true",
                      help="not ported yet (ROADMAP Queue 1 step 14)")
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--bands", "--mesh-rows", dest="bands", type=int,
                   default=None,
                   help="not ported yet (ROADMAP Queue 1 step 14)")
    _add_synth_flags(p)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("batch", help="stylize a directory of frames")
    _add_frames_flags(p)
    p.add_argument(
        "--frames-per-step", type=int, default=None,
        help="process frames in sequential chunks of this size (bounds "
        "device memory; outputs do not depend on it)",
    )
    _add_synth_flags(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser(
        "video",
        help="stylize a frame sequence with temporal warm starts: the "
        "previous frame's fields seed the next, tau-weighted temporal "
        "coherence, delta-sized schedules",
    )
    _add_frames_flags(p)
    p.add_argument(
        "--warm", default=None, choices=["on", "off"],
        help="warm-start switch (IA_VIDEO_WARM): 'off' runs every frame "
        "cold through the batch runner (default: on, or the environment's "
        "value)",
    )
    _add_synth_flags(p)
    p.set_defaults(fn=cmd_video)

    p = sub.add_parser("examples", help="generate procedural example assets")
    _add_common_flags(p)
    p.add_argument("--out", default="examples")
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(fn=cmd_examples)

    args = parser.parse_args(argv)
    from .utils.progress import configure_logging

    configure_logging(getattr(args, "log_level", None))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

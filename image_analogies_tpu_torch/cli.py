"""Command line of the port: `python -m image_analogies_tpu_torch.cli`.

Subcommands:
  synth     A + A' + B -> B'
  batch     A + A' + a directory of frames -> stylized frames
  video     A + A' + a frame sequence -> stylized frames, warm-started
  examples  write the procedural example assets
  health    the run sentinel over a traced run's directory -> health.json
  report    a traced run's host spans joined with its device trace ->
            report.json
  serve     the synthesis daemon: POST /synthesize over HTTP, with a
            request queue, continuous batching, admission control, a
            journal with drain and takeover, and video sessions
  trace     one served request's critical path, from a live daemon
            (--url) or its artifacts (--trace-dir)

The flags are the reference CLI's (`image_analogies_tpu/cli.py`), with
`--device {cuda,cpu}` (default cuda; a run without a card raises unless
it asks for the CPU, and `--device cpu` never initialises CUDA).  The
kernels' build directory, `build/ia_torch_kernels/`, takes the place of
the reference's compilation cache.

Flags of parts not ported yet keep the reference's parser, so a bad
value still fails at parse time, and then stop the run with a message
naming the ROADMAP step that ports them: `--spatial`, `--sharded-a`,
`--bands`, `--n-devices` (step 14, multi-device); serve's `--lattice`,
`--warm-dir`, `--archive-dir`, `--archive-interval-s` and trace's
`--fleet` (step 13b, the fleet).

`--trace-dir DIR` writes the telemetry artifacts (host_spans.json,
metrics.json, metrics.prom, flight.json) and costs one device sync a
level; `--profile DIR` writes a `torch.profiler` trace of the run
(`torch_trace.json`) and adds no sync of its own.  The two are
independent: a run may take both, and `report` joins them when they
name the same directory.  `--health` grades the finished run with the
run sentinel (health.json beside the artifacts; a violated verdict
flushes the flight recorder); `--metrics-port PORT` serves /metrics,
/metrics.json, /healthz and /progress while the run runs (0: an
ephemeral port, announced in `<trace-dir>/live.json`).  Both imply the
instrumented run (one device sync a level).
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
        help="evaluate the run sentinel at the end of the run "
        "(expected-vs-observed byte-ledger checks + span/energy "
        "invariants, telemetry/sentinel.py), print the verdict, and write "
        "health.json beside the other --trace-dir artifacts.  Implies "
        "instrumentation (one device sync a level)",
    )
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve live telemetry mid-run on 127.0.0.1:PORT (0 = "
        "ephemeral port): /metrics (Prometheus exposition), /metrics.json, "
        "/healthz (incremental sentinel verdict; HTTP 503 when violated), "
        "/progress (open span stack + model-calibrated ETA).  The bound "
        "endpoint is announced in <trace-dir>/live.json when --trace-dir "
        "is set.  Implies instrumentation (one device sync a level)",
    )


# Flags of parts not ported yet: (attribute, flag, the ROADMAP step).
_UNPORTED = (
    ("spatial", "--spatial", "step 14 (multi-device runners)"),
    ("sharded_a", "--sharded-a", "step 14 (multi-device runners)"),
    ("bands", "--bands", "step 14 (multi-device runners)"),
    ("n_devices", "--n-devices", "step 14 (multi-device runners)"),
)


# serve's and trace's: (attribute, flag, the ROADMAP step, its off value).
_STEP_13B = "step 13b (the serving fleet)"
_SERVE_UNPORTED = (
    ("n_devices", "--n-devices", "step 14 (multi-device runners)", None),
    ("lattice", "--lattice", _STEP_13B, "off"),
    ("warm_dir", "--warm-dir", _STEP_13B, None),
    ("archive_dir", "--archive-dir", _STEP_13B, None),
    ("archive_interval_s", "--archive-interval-s", _STEP_13B, None),
    ("fleet", "--fleet", _STEP_13B, None),
)


def _refuse_unported(args, table=None) -> None:
    """Stop before any image loads when a flag of an unported part was
    given: it is never ignored."""
    if table is None:
        table = tuple(row + (None,) for row in _UNPORTED)
    for attr, flag, step, off in table:
        value = getattr(args, attr, None)
        if value is not None and value is not False and value != off:
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


def _emit_health(tracer, trace_dir, context: str) -> None:
    """The `--health` epilogue of synth, batch and video: the sentinel
    over the finished run's tracer and registry, health.json beside the
    other artifacts when a telemetry directory exists, and the verdict
    printed.  A violated verdict flushes the flight recorder, reached
    through the handle the session left on the tracer (the session has
    torn down by now: the outputs are saved first)."""
    from .telemetry.sentinel import (
        HEALTH_FILE,
        evaluate_health,
        render_health,
        write_health,
    )

    health = evaluate_health(
        spans=tracer.to_dict() if tracer.enabled else None,
        metrics=(
            tracer.registry.to_dict()
            if tracer.registry is not None else None
        ),
        context=context,
    )
    if trace_dir:
        write_health(health, os.path.join(trace_dir, HEALTH_FILE))
    recorder = getattr(tracer, "flight_recorder", None)
    if recorder is not None and health["verdict"] == "violated":
        recorder.flush("violation")
    print(render_health(health))


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
    is instrumented (a progress stream, a telemetry directory, the
    sentinel, the live exporter or the supervisor; `--profile` alone is
    not).  Returns (cfg, ckpt_dir, ckpt_ephemeral, instrument)."""
    _refuse_unported(args)
    _apply_cand_compression(args)
    cfg = _config_from(args)
    instrument = bool(
        args.progress or args.trace_dir or args.health
        or args.metrics_port is not None or args.supervise
    )
    cfg, ckpt_dir, ephemeral = _force_ckpt_dir(args, cfg)
    return cfg, ckpt_dir, ephemeral, instrument


def _session(args, progress, instrument, cfg):
    from .utils.profiling import telemetry_session

    return telemetry_session(
        args.profile, sink=progress, enabled=instrument,
        artifact_dir=args.trace_dir, cuda=cfg.device == "cuda",
        metrics_port=args.metrics_port,
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
    # After the output is saved: a verdict or its IO never discards a
    # finished synthesis.
    if args.health:
        _emit_health(tracer, args.trace_dir, "synth")
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
    host, names, failures, t0, the session's tracer)."""
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
    return bps, names, failures, t0, tracer


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

    bps, names, failures, t0, tracer = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    _write_frames(args, names, bps, failures, progress)
    print(f"wrote {len(names)} frames to {args.out} "
          f"({time.perf_counter() - t0:.2f}s)")
    if args.health:
        _emit_health(tracer, args.trace_dir, "batch")
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

    bps, names, failures, t0, tracer = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    _write_frames(args, names, bps, failures, progress)
    print(f"wrote {len(names)} frames to {args.out} "
          f"({time.perf_counter() - t0:.2f}s, warm={args.warm or 'on'})")
    if args.health:
        _emit_health(tracer, args.trace_dir, "video")
    return 0


def cmd_serve(args) -> int:
    """Synthesis as a service (serving/): a long-lived daemon over one
    style pair, serving POST /synthesize with executable-cache
    accounting, continuous batching and admission control, on the same
    HTTP server and telemetry surface (/metrics, /healthz, live.json)
    every traced run uses.  On `--device` (default cuda: a machine
    without a card stops here, it never falls back to the CPU)."""
    _refuse_unported(args, _SERVE_UNPORTED)
    _apply_cand_compression(args)
    import dataclasses
    import signal

    from .models.analogy import resolve_device
    from .serving.daemon import SynthDaemon
    from .serving.excache import load_warmup_manifest
    from .utils.io import load_image
    from .utils.profiling import telemetry_session

    cfg = _config_from(args)
    try:
        resolve_device(cfg)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}")
    if cfg.save_level_artifacts:
        # The daemon owns per-dispatch checkpoint dirs (retry-with-
        # resume inside one dispatch); a shared user path would make
        # concurrent dispatches clobber each other's state.
        print(
            "serve: ignoring --save-level-artifacts (checkpoints are "
            "per-dispatch-managed)", file=sys.stderr,
        )
        cfg = dataclasses.replace(cfg, save_level_artifacts=None)
    warm_entries = None
    if args.warmup:
        try:
            warm_entries = load_warmup_manifest(args.warmup)
        except (OSError, ValueError) as e:
            raise SystemExit(f"serve: --warmup: {e}")
    a = load_image(args.a)
    ap = load_image(args.ap)
    # --takeover DIR is --state-dir DIR made explicit: both restart
    # paths restore sessions, merge observed warmup, and replay the
    # journal's pending entries.
    state_dir = args.takeover or args.state_dir
    anomaly_config = None
    if args.baseline:
        from .telemetry.anomaly import AnomalyConfig, baseline_from_record

        baseline_p99 = baseline_from_record(args.baseline)
        if baseline_p99 is None:
            print(
                f"serve: --baseline {args.baseline}: no "
                "pipeline.p99_warm_ms — latency watch will report "
                "no_data", file=sys.stderr,
            )
        anomaly_config = AnomalyConfig(baseline_p99_ms=baseline_p99)
    # Daemon-lifetime telemetry session: no device trace over an
    # unbounded lifetime; artifacts and the flight recorder go to
    # --trace-dir.  SIGTERM is re-bound to a drain below.
    with telemetry_session(
        None, enabled=True, artifact_dir=args.trace_dir,
        cuda=cfg.device == "cuda", flight_capacity=args.flight_ring,
    ) as tracer:
        daemon = SynthDaemon(
            a, ap, cfg,
            registry=tracer.registry,
            tracer=tracer,
            host=args.host,
            port=args.port,
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            max_queue_depth=args.max_queue_depth,
            cache_capacity=args.cache_capacity,
            max_retries=args.max_retries,
            max_sessions=args.max_sessions,
            flight=getattr(tracer, "flight_recorder", None),
            # The access log beside the other trace artifacts, where
            # `trace --trace-dir` looks.
            access_log_path=(
                os.path.join(args.trace_dir, "access.jsonl")
                if args.trace_dir else None
            ),
            state_dir=state_dir,
            drain_deadline_s=args.drain_deadline_s,
            dispatch_deadline_s=args.dispatch_deadline_s,
            pipeline_window=args.pipeline_window,
            warmup_workers=args.warmup_workers,
            obs_interval_s=args.obs_interval_s,
            obs_capacity=args.obs_capacity,
            anomaly_config=anomaly_config,
        )
        try:
            daemon.start()
        except RuntimeError as e:
            # The double-takeover guard: the state dir's lockfile
            # names a pid that is still alive.
            raise SystemExit(f"serve: {e}")
        # Graceful drain on SIGTERM: in-flight requests and their
        # response writes complete, the hand-off state lands in the
        # state dir, the flight dump says reason=drain, and the loop
        # below exits 0.
        signal.signal(
            signal.SIGTERM,
            lambda signum, frame: daemon.begin_drain(reason="sigterm"),
        )
        try:
            restored = daemon.restore_sessions() if state_dir else 0
            if restored:
                print(f"takeover: restored {restored} session(s)")
            for rec in daemon.warmup(warm_entries or []):
                print(
                    f"warmup: {rec['key']} first use in "
                    f"{rec['wall_ms']:.0f} ms"
                )
            replayed = daemon.replay_journal() if state_dir else 0
            if replayed:
                print(
                    f"takeover: replaying {replayed} journaled "
                    "request(s)"
                )
            # Rendezvous AFTER warmup: a live.json reader may assume
            # the manifest's shapes are already warm.
            if args.trace_dir:
                daemon.live.announce(args.trace_dir)
            print(
                f"serving on {daemon.url} (POST /synthesize /drain; "
                "GET /serving /slo /journal /obs/window /request "
                "/metrics /metrics.json /healthz /progress)",
                flush=True,
            )
            while not daemon.drained.wait(1.0):
                pass
            print("serve: drained, exiting", flush=True)
        except KeyboardInterrupt:
            print("serve: interrupted, draining")
        finally:
            daemon.stop()
    return 0


# The reconstruction bound `trace` checks: the phases of a dispatched
# request explain its end-to-end latency to within this share.
TRACE_GAP_PCT_MAX = 5.0


def cmd_trace(args) -> int:
    """Reconstruct one served request's critical path: the access log
    is the source of truth for phase attribution (queue/compile/
    execute/demux ms the daemon booked at response time), joined, when
    the artifacts exist, with the request's `serve_request` span tree
    from flight.json.  `--url` asks a live daemon instead (GET
    /request?id=).  Prints a phase-attributed waterfall; exits nonzero
    when the id is unknown, and 1 when a dispatched request's phases
    leave more than TRACE_GAP_PCT_MAX percent of its latency
    unexplained."""
    import json

    from .serving.accesslog import phase_fields

    _refuse_unported(args, _SERVE_UNPORTED)
    if bool(args.url) == bool(args.trace_dir):
        raise SystemExit(
            "trace: exactly one of --url (live daemon) or --trace-dir "
            "(post-mortem artifacts) is required"
        )
    if args.url:
        import urllib.error
        import urllib.parse
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith(("http://", "https://")):
            base = "http://" + base
        url = (base + "/request?id="
               + urllib.parse.quote(args.request_id, safe=""))
        try:
            with urllib.request.urlopen(url, timeout=10.0) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read().decode("utf-8")).get(
                    "error", ""
                )
            except (ValueError, OSError):
                detail = ""
            raise SystemExit(
                f"trace: request {args.request_id!r}: daemon answered "
                f"{e.code}" + (f" ({detail})" if detail else "")
            )
        except (urllib.error.URLError, OSError) as e:
            raise SystemExit(f"trace: cannot reach {args.url}: {e}")
        rec = doc.get("request") or {}
        flight_evs = doc.get("flight_events") or []
    else:
        from .serving.accesslog import find_request

        log_path = args.access_log or os.path.join(
            args.trace_dir, "access.jsonl"
        )
        rec = find_request(log_path, args.request_id)
        if rec is None:
            raise SystemExit(
                f"trace: request {args.request_id!r} not found in "
                f"{log_path} (or its rotations)"
            )
        # Optional flight-side join: the daemon replays each settled
        # request's span tree through the flight recorder, so a request
        # still inside the ring's window has events here too.
        flight_evs = []
        flight_path = os.path.join(args.trace_dir, "flight.json")
        if os.path.exists(flight_path):
            from .telemetry.flight import read_flight, request_events

            try:
                flight_evs = request_events(
                    read_flight(flight_path), args.request_id
                )
            except (OSError, ValueError):
                flight_evs = []
    total_ms = float(rec.get("total_ms") or 0.0)
    phases = phase_fields(rec)
    attributed = sum(ms for _, ms in phases)
    gap = total_ms - attributed
    gap_pct = 100.0 * gap / total_ms if total_ms > 0 else 0.0
    # Only a request that reached `executed` carries the whole split.
    over = "execute_ms" in rec and abs(gap_pct) > TRACE_GAP_PCT_MAX
    if args.format == "json":
        print(json.dumps(
            {"access": rec, "flight_events": flight_evs}, indent=1
        ))
        return 1 if over else 0
    print(
        f"request {rec.get('request_id')}  outcome={rec.get('outcome')}"
        f"  http={rec.get('http_status')}  cache={rec.get('cache', '-')}"
        f"  session={rec.get('session_id') or '-'}"
    )
    if rec.get("exec_key"):
        print(f"  exec_key {rec['exec_key']}")
    if rec.get("ts"):
        print(f"  ts {rec['ts']}  bytes_in {rec.get('bytes_in', 0)}"
              f"  bytes_out {rec.get('bytes_out', 0)}")
    width = 32
    for name, ms in phases:
        frac = ms / total_ms if total_ms > 0 else 0.0
        bar = "#" * max(1, int(round(frac * width))) if ms > 0 else ""
        print(f"  {name:8s} {ms:10.3f} ms  {100.0 * frac:5.1f}%  {bar}")
    print(
        f"  {'phases':8s} {attributed:10.3f} ms  vs total "
        f"{total_ms:.3f} ms (gap {gap:.3f} ms, {gap_pct:.2f}%)"
        + (f"  OVER the {TRACE_GAP_PCT_MAX:g}% bound" if over else "")
    )
    if flight_evs:
        closes = [ev for ev in flight_evs if ev.get("kind") == "close"]
        root = next(
            (ev for ev in closes if ev.get("name") == "serve_request"),
            None,
        )
        extra = (
            f"; serve_request wall {root['wall_ms']:.3f} ms"
            if root and root.get("wall_ms") is not None else ""
        )
        print(f"  flight: {len(flight_evs)} span events{extra}")
    return 1 if over else 0


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


def cmd_report(args) -> int:
    """Merge a traced run's host spans with its device trace into
    report.json and a table (telemetry/report.py)."""
    import json

    from .telemetry.report import (
        REPORT_FILE,
        build_report,
        render_table,
        write_report,
    )

    try:
        report = build_report(
            trace_dir=args.trace_dir, progress_path=args.progress
        )
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"report: {e}")
    out = args.out or os.path.join(args.trace_dir, REPORT_FILE)
    write_report(report, out)
    if args.format == "json":
        print(json.dumps(report, indent=1))
    else:
        print(render_table(report))
    print(f"wrote {out}")
    return 0


def cmd_health(args) -> int:
    """Offline run sentinel: evaluate a traced run's telemetry directory
    (host_spans.json + metrics.json), write health.json beside them, and
    exit 1 on a violated verdict (telemetry/sentinel.py)."""
    import json

    from .telemetry.sentinel import (
        HEALTH_FILE,
        health_from_trace_dir,
        render_health,
        write_health,
    )

    try:
        health = health_from_trace_dir(args.trace_dir)
    except (FileNotFoundError, ValueError) as e:
        # ValueError: a corrupt metrics.json (unparseable label keys).
        raise SystemExit(f"health: {e}")
    out = args.out or os.path.join(args.trace_dir, HEALTH_FILE)
    write_health(health, out)
    if args.format == "json":
        print(json.dumps(health, indent=1))
    else:
        print(render_health(health))
    print(f"wrote {out}")
    return 1 if health["verdict"] == "violated" else 0


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

    p = sub.add_parser(
        "serve",
        help="synthesis-as-a-service daemon: request queue + "
        "executable-cache accounting + continuous batching + admission "
        "control over HTTP (serving/)",
    )
    p.add_argument("--a", required=True)
    p.add_argument("--ap", required=True)
    p.add_argument(
        "--port", type=int, default=0,
        help="bind port (0 = ephemeral; the bound endpoint prints on "
        "stdout and announces in <trace-dir>/live.json)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--n-devices", type=int, default=None,
                   help="not ported yet (ROADMAP Queue 1 step 14)")
    p.add_argument(
        "--max-batch", type=int, default=None, metavar="N",
        help="continuous-batching dispatch grain (default 1, the "
        "device count).  Every dispatch pads to exactly this many "
        "frames so repeat request shapes share one cache entry",
    )
    p.add_argument(
        "--max-wait-ms", type=float, default=25.0, metavar="MS",
        help="longest the queue head waits for co-batchable requests "
        "before a partial batch flushes (default 25)",
    )
    p.add_argument(
        "--max-queue-depth", type=int, default=32, metavar="N",
        help="admission limit: requests beyond this backlog "
        "(admitted and not yet answered) are shed with 429 + "
        "Retry-After; the "
        "limit halves while the backend's straggler/degradation "
        "gauges read degraded (default 32)",
    )
    p.add_argument(
        "--cache-capacity", type=int, default=8, metavar="N",
        help="executable-cache residency (default 8).  Eviction is "
        "epoch-grained (serving/excache.py): size this so eviction is "
        "rare",
    )
    p.add_argument(
        "--warmup", default=None, metavar="MANIFEST",
        help="serve_warmup JSON manifest of expected request shapes, "
        "dispatched through the real path before the endpoint "
        "announces: the first client request of each listed shape "
        "is then a cache hit",
    )
    p.add_argument(
        "--max-sessions", type=int, default=16, metavar="N",
        help="video session-affinity streams held live (LRU).  A "
        "/synthesize request carrying session_id pins to a "
        "per-session warm-start stream; the least-recently-used "
        "stream beyond this count is dropped and its next frame runs "
        "cold (default 16)",
    )
    p.add_argument(
        "--state-dir", default=None, metavar="DIR",
        help="crash-resilience state dir: every admitted "
        "request journals to DIR/journal.jsonl before its ack, drain "
        "snapshots hand-off state there, and a restart replays the "
        "journal's unfinished entries (bit-identical by the isolation "
        "contract).  DIR/daemon.lock refuses a second live daemon",
    )
    p.add_argument(
        "--warm-dir", default=None, metavar="DIR",
        help="fleet-shared warm tier: not ported yet (ROADMAP Queue 1 "
        "step 13b)",
    )
    p.add_argument(
        "--takeover", default=None, metavar="DIR",
        help="take over a dead/drained daemon's state dir: restore "
        "its snapshotted sessions, merge its runtime-observed warmup "
        "shapes, and replay its journaled unfinished requests "
        "(equivalent to --state-dir DIR; refused while the previous "
        "holder's pid is alive)",
    )
    p.add_argument(
        "--drain-deadline-s", type=float, default=30.0, metavar="S",
        help="graceful-drain budget (SIGTERM or POST /drain): new "
        "requests 503 immediately; queued + in-flight work and their "
        "response writes get this long to finish before the hand-off "
        "snapshot is cut and the daemon exits 0 (default 30)",
    )
    p.add_argument(
        "--dispatch-deadline-s", type=float, default=None, metavar="S",
        help="bound one batch dispatch: past this wall the "
        "dispatcher's abort token fires and the wedged attempt "
        "unwinds as a failed (500) batch instead of freezing the "
        "daemon (default: unbounded)",
    )
    p.add_argument(
        "--pipeline-window", type=int, default=2, metavar="N",
        help="pipelined-dispatch in-flight window: up to N "
        "dispatched batches may be unsettled at once, so host-side "
        "demux/response work of batch t overlaps device execution of "
        "batch t+1.  1 = the serial loop (default 2)",
    )
    p.add_argument(
        "--warmup-workers", type=int, default=4, metavar="N",
        help="threads warming distinct warmup shapes concurrently "
        "before the endpoint announces (default 4, 1 = sequential)",
    )
    p.add_argument(
        "--obs-interval-s", type=float, default=5.0, metavar="S",
        help="time-series ring sampling interval: every S "
        "seconds the registry snapshots into the windowed-rate ring "
        "GET /obs/window serves, and the anomaly watches re-grade.  "
        "<= 0 disables the observatory plane (default 5)",
    )
    p.add_argument(
        "--obs-capacity", type=int, default=120, metavar="N",
        help="time-series ring length in snapshots (default 120 = a "
        "10-minute window at the default interval; memory is N "
        "serialized registry snapshots)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="RECORD",
        help="SERVE-record JSON measured on this card whose "
        "pipeline.p99_warm_ms anchors the anomaly detector's latency "
        "envelope; omitted = the latency watch reports no_data",
    )
    p.add_argument(
        "--archive-dir", default=None, metavar="DIR",
        help="durable telemetry archive + black box: not ported yet "
        "(ROADMAP Queue 1 step 13b)",
    )
    p.add_argument(
        "--archive-interval-s", type=float, default=None, metavar="S",
        help="archive snapshot cadence: not ported yet (ROADMAP Queue 1 "
        "step 13b)",
    )
    p.add_argument(
        "--flight-ring", type=int, default=None, metavar="N",
        help="flight-recorder event-ring capacity (default: "
        "IA_FLIGHT_RING env or 512; memory scales linearly, "
        "~200-500 bytes per event)",
    )
    p.add_argument(
        "--lattice", default=None, metavar="SPEC",
        help="shape-lattice admission: not ported yet (ROADMAP Queue 1 "
        "step 13b); 'off' is accepted",
    )
    _add_synth_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "trace",
        help="reconstruct one serving request's critical path from the "
        "daemon's access log (+ flight.json span join): phase-"
        "attributed waterfall for a request id (exit 1 if not found or "
        "over the 5%% reconstruction bound)",
    )
    _add_common_flags(p)
    p.add_argument(
        "request_id",
        help="the request id to reconstruct (echoed in every "
        "/synthesize response and error body)",
    )
    p.add_argument(
        "--trace-dir", default=None, metavar="DIR",
        help="the serve daemon's --trace-dir (access.jsonl + "
        "flight.json live here); exactly one of --trace-dir/--url",
    )
    p.add_argument(
        "--url", default=None, metavar="URL",
        help="ask a LIVE daemon over HTTP instead of reading "
        "artifacts (GET /request?id=); exactly one of "
        "--trace-dir/--url",
    )
    p.add_argument(
        "--fleet", default=None, metavar="DISCOVERY",
        help="cross-process fleet waterfall: not ported yet (ROADMAP "
        "Queue 1 step 13b)",
    )
    p.add_argument(
        "--access-log", default=None, metavar="JSONL",
        help="explicit access-log path (default: "
        "<trace-dir>/access.jsonl)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("examples", help="generate procedural example assets")
    _add_common_flags(p)
    p.add_argument("--out", default="examples")
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(fn=cmd_examples)

    p = sub.add_parser(
        "report",
        help="merge a traced run's host spans + device trace into "
        "report.json (input: a synth/batch/video directory given as both "
        "--trace-dir and --profile)",
    )
    _add_common_flags(p)
    p.add_argument(
        "--trace-dir", required=True, metavar="DIR",
        help="telemetry directory a traced run wrote "
        "(host_spans.json / metrics.json / torch_trace.json)",
    )
    p.add_argument(
        "--progress", default=None, metavar="JSONL",
        help="progress stream to reconstruct host spans from when the "
        "trace dir has no host_spans.json",
    )
    p.add_argument(
        "--out", default=None,
        help="report path (default: <trace-dir>/report.json)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser(
        "health",
        help="run sentinel over a traced run's telemetry directory: "
        "expected-vs-observed model checks + run invariants -> "
        "health.json (exit 1 on a violated verdict)",
    )
    _add_common_flags(p)
    p.add_argument(
        "--trace-dir", required=True, metavar="DIR",
        help="telemetry directory a traced run wrote "
        "(host_spans.json / metrics.json)",
    )
    p.add_argument(
        "--out", default=None,
        help="health path (default: <trace-dir>/health.json)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_health)

    args = parser.parse_args(argv)
    from .utils.progress import configure_logging

    configure_logging(getattr(args, "log_level", None))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

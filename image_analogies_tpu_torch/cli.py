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
            (--url), its artifacts (--trace-dir), or across a fleet
            (--fleet: the router's discovery file)
  route     the fleet router over serve replicas: least outstanding
            work, session affinity, drain-time session migration, and
            a discovery file for obs and trace --fleet
  obs       the fleet observatory: scrape N replicas, pool their
            registries, grade the pooled SLO, write an OBS record
  history   the restart lineage of a telemetry archive (--archive-dir)
  incident  render one black-box incident bundle

The flags are the reference CLI's (`image_analogies_tpu/cli.py`), with
`--device {cuda,cpu}` (default cuda; a run without a card raises unless
it asks for the CPU, and `--device cpu` never initialises CUDA).  The
kernels' build directory, `build/ia_torch_kernels/`, takes the place of
the reference's compilation cache.

Multi-device runs (parallel/): `synth --spatial` (B' row slabs; with
`--bands N` / `--mesh-rows N` also A ownership bands on a 2-D
("bands", "slabs") mesh, else the mesh planner's shape) and `synth
--sharded-a` (A band-sharded), and `--n-devices N` on synth, batch and
video (frames over the ranks; video with `--warm off` only).  The
command starts its N ranks itself (one process each,
`parallel.mesh.spawn`; rank r on cuda:r, NCCL, or on the CPU through
gloo), or joins the `torchrun` world its environment
names (WORLD_SIZE).  Rank 0 alone writes the outputs, the telemetry,
the progress stream and the health verdict.  `--supervise` runs on one
rank.  A flag of a part not ported yet keeps the reference's parser, so
a bad value still fails at parse time, and then stops the run with a
message naming the ROADMAP step that ports it: `serve --n-devices`
(step 14b, multi-device serving).

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
    """Install --cand-dtype / --pca-prune process-wide (engine modes,
    not config fields); a malformed prune spec fails before the images
    load."""
    given = {k: v for k, v in (("cand_dtype", args.cand_dtype),
                               ("prune", args.pca_prune)) if v is not None}
    if not given:
        return
    from .config import set_engine_modes

    try:
        set_engine_modes(**given)
    except ValueError as e:
        raise SystemExit(f"--cand-dtype/--pca-prune: {e}")


def _start(args):
    """What every synthesis command does first: install the compression
    modes, configure, and decide whether the run
    is instrumented (a progress stream, a telemetry directory, the
    sentinel, the live exporter or the supervisor; `--profile` alone is
    not).  On a rank other than 0 of a multi-rank run, the run keeps
    rank 0's instrumentation (the shard walls are collectives) but
    writes no progress stream, telemetry or profile.  Returns (cfg,
    ckpt_dir, ckpt_ephemeral, instrument)."""
    _apply_cand_compression(args)
    cfg = _config_from(args)
    instrument = bool(
        args.progress or args.trace_dir or args.health
        or args.metrics_port is not None or args.supervise
    )
    if not _is_rank0():
        args.progress = args.trace_dir = args.profile = None
        args.metrics_port = None
        args.health = False
    cfg, ckpt_dir, ephemeral = _force_ckpt_dir(args, cfg)
    return cfg, ckpt_dir, ephemeral, instrument


def _is_rank0() -> bool:
    from .parallel.mesh import world_rank

    return world_rank() == 0


def _default_ranks(args) -> int:
    """`--n-devices`, else every card for a CUDA run, else 1.  A CUDA
    run asking for more ranks than the machine has cards stops."""
    if args.n_devices is not None:
        if args.n_devices < 1:
            raise SystemExit(f"--n-devices {args.n_devices}: need >= 1")
        if args.device == "cuda":
            import torch

            have = torch.cuda.device_count()
            if args.n_devices > have:
                raise SystemExit(f"--n-devices {args.n_devices}: requested "
                                 f"{args.n_devices} devices, have {have}")
        return args.n_devices
    if args.device == "cuda":
        import torch

        return max(1, torch.cuda.device_count())
    return 1


def _rank_command(args):
    """One spawned rank of a multi-rank command: the command itself,
    inside the world `parallel.mesh.spawn` started."""
    return args.fn(args)


def _in_world(args, n_ranks: int):
    """How a command that may run on several ranks proceeds: None when
    it runs here (already inside a world, a `torchrun` world joined, or
    one rank), else rank 0's exit code after the command ran on
    `n_ranks` ranks of its own."""
    import torch.distributed as dist

    from .parallel.mesh import backend_for, initialize_multihost, spawn

    if dist.is_initialized():
        return None
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        if args.device == "cuda":
            import torch

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        initialize_multihost(backend=backend_for(args.device))
        return None
    if n_ranks <= 1:
        return None
    if args.supervise:
        raise SystemExit("--supervise runs on one rank; drop --n-devices "
                         "or --supervise")
    return spawn(_rank_command, n_ranks, device_type=args.device,
                 args=(args,))


class _OwnWorld:
    """A one-rank world the command started for a mesh of one (see
    `parallel.mesh.make_mesh`) ends with the command, so a later
    command in the same process starts its own ranks again."""

    def __enter__(self):
        import torch.distributed as dist

        self._had = dist.is_initialized()
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if not self._had and dist.is_initialized():
            dist.destroy_process_group()
        return False


def _synth_mesh(args, cfg, a_shape, b_shape):
    """(runner, mesh, mesh_plan) of a synth run: the spatial runner on a
    1-D mesh or, when `--bands` or the planner asks for bands, on the
    2-D ("bands", "slabs") mesh; the sharded-A runner on a "bands" mesh;
    else the single-device runner."""
    from .parallel.mesh import make_mesh, world_size

    if args.bands is not None and args.bands > 1 and not args.spatial:
        raise SystemExit(
            "--bands requires --spatial (it names the A-band axis of the "
            "2-D bands x slabs mesh); for A-side banding alone use "
            "--sharded-a"
        )
    if not (args.spatial or args.sharded_a):
        return "single", None, None
    n_dev = world_size()
    if args.sharded_a:
        return "sharded_a", make_mesh(n_dev, axis_names=("bands",),
                                      device_type=cfg.device), None
    from .parallel.plan2d import override_plan, plan_mesh_shape

    if args.bands is not None:
        if args.bands < 1 or n_dev % args.bands:
            raise SystemExit(f"--bands {args.bands} must divide the "
                             f"device count ({n_dev})")
        plan = override_plan(args.bands, n_dev // args.bands)
    else:
        plan = plan_mesh_shape(n_dev, a_shape[:2], b_shape[:2], cfg)
    if plan.n_bands > 1:
        mesh = make_mesh(n_dev, axis_names=("bands", "slabs"),
                         shape=(plan.n_bands, plan.n_slabs),
                         device_type=cfg.device)
    else:
        mesh = make_mesh(n_dev, device_type=cfg.device)
    return "spatial", mesh, plan.as_attrs()



def _session(args, progress, instrument, cfg):
    from .utils.profiling import telemetry_session

    return telemetry_session(
        args.profile, sink=progress, enabled=instrument,
        artifact_dir=args.trace_dir, cuda=cfg.device == "cuda",
        metrics_port=args.metrics_port,
    )


def cmd_synth(args) -> int:
    n_ranks = (_default_ranks(args) if args.spatial or args.sharded_a
               else 1)
    code = _in_world(args, n_ranks)
    if code is not None:
        return code
    with _OwnWorld():
        return _synth(args)


def _synth(args) -> int:
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .models.analogy import ResumeError, create_image_analogy
    from .utils.io import load_image, save_image
    from .utils.progress import ProgressWriter

    progress = ProgressWriter(args.progress)
    a = load_image(args.a)
    ap = load_image(args.ap)
    b = load_image(args.b)
    runner, mesh, mesh_plan = _synth_mesh(args, cfg, a.shape, b.shape)
    t0 = time.perf_counter()
    with _session(args, progress, instrument, cfg) as tracer:
        # A disabled tracer: events still reach the JSONL/log stream
        # through the writer itself.
        events = tracer if tracer.enabled else progress
        events.emit("start", shape=list(b.shape), matcher=cfg.matcher)
        strict_state = {"first": True}

        def _dispatch(resume_from):
            kw = dict(
                progress=tracer if instrument else None,
                resume_from=resume_from,
                resume_strict=_resume_strict_for(args, resume_from,
                                                 strict_state),
            )
            if runner == "spatial":
                from .parallel.spatial import synthesize_spatial

                return synthesize_spatial(a, ap, b, cfg, mesh,
                                          mesh_plan=mesh_plan, **kw)
            if runner == "sharded_a":
                from .parallel.sharded_a import synthesize_sharded_a

                return synthesize_sharded_a(a, ap, b, cfg, mesh, **kw)
            return create_image_analogy(a, ap, b, cfg, **kw)

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
    if not _is_rank0():
        return 0
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


def _frames_mesh(args, cfg):
    """The "batch" mesh of a batch or video run over several ranks."""
    from .parallel.mesh import make_mesh, world_size

    if world_size() == 1:
        return None
    return make_mesh(world_size(), axis_names=("batch",),
                     device_type=cfg.device)


def cmd_batch(args) -> int:
    code = _in_world(args, args.n_devices or 1)
    if code is not None:
        return code
    return _batch(args)


def _batch(args) -> int:
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .parallel.batch import synthesize_batch
    from .utils.progress import ProgressWriter

    progress = ProgressWriter(args.progress)
    mesh = _frames_mesh(args, cfg)

    def run(a, ap, frames, prog, resume_from, strict):
        return synthesize_batch(
            a, ap, frames, cfg, frames_per_step=args.frames_per_step,
            resume_from=resume_from, resume_strict=strict, progress=prog,
            mesh=mesh,
        )

    bps, names, failures, t0, tracer = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    if not _is_rank0():
        return 0
    _write_frames(args, names, bps, failures, progress)
    print(f"wrote {len(names)} frames to {args.out} "
          f"({time.perf_counter() - t0:.2f}s)")
    if args.health:
        _emit_health(tracer, args.trace_dir, "batch")
    return 0


def cmd_video(args) -> int:
    """A frame sequence with temporal warm starts (video/): the batch
    command's ingest, telemetry and --supervise, frame-granular resume
    through the per-frame `frames_{t:05d}` checkpoint directories.
    Several ranks serve only the warm-off batch dispatch: the warm path
    runs its frames in turn, each started from the one before, so over
    ranks every rank would run the whole sequence; it is refused."""
    from .video.sequence import warm_mode

    n_ranks = max(args.n_devices or 1,
                  int(os.environ.get("WORLD_SIZE", "1") or 1))
    if n_ranks > 1 and (args.warm or warm_mode()) != "off":
        raise SystemExit(
            f"video over {n_ranks} ranks needs --warm off: the warm path "
            "runs its frames in turn, so every rank would run the whole "
            "sequence; the ranks split the frames of the warm-off batch "
            "dispatch only"
        )
    code = _in_world(args, args.n_devices or 1)
    if code is not None:
        return code
    return _video(args)


def _video(args) -> int:
    cfg, ckpt_dir, ckpt_ephemeral, instrument = _start(args)
    from .utils.progress import ProgressWriter
    from .video import set_warm_mode, synthesize_video

    if args.warm:
        set_warm_mode(args.warm)
    progress = ProgressWriter(args.progress)
    # The mesh serves the warm-off batch dispatch (`cmd_video` refuses
    # the warm path over several ranks).
    mesh = _frames_mesh(args, cfg)

    def run(a, ap, frames, prog, resume_from, strict):
        return synthesize_video(
            a, ap, frames, cfg, resume_from=resume_from,
            resume_strict=strict, progress=prog, mesh=mesh,
        )

    bps, names, failures, t0, tracer = _run_frames(
        args, cfg, ckpt_dir, ckpt_ephemeral, instrument, progress, run)
    if not _is_rank0():
        return 0
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
    without a card stops here, it never falls back to the CPU).

    `--n-devices N` (default: every card of a CUDA run; one card, or the
    CPU, is one process) makes this process rank 0 of a world of N
    ranks whose sessionless dispatches run over all of them
    (serving/ranks.py); under `torchrun` the world is joined, rank 0
    serves and the others follow.  Exit 0 after a drain that ended
    every rank with 0; nonzero when the world lost a rank (after a
    drain that kept the journal for `--takeover`) or a rank did not end
    cleanly."""
    _apply_cand_compression(args)
    from .models.analogy import resolve_device

    cfg = _config_from(args)
    try:
        resolve_device(cfg)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}")
    followers = _serve_world(args)
    if followers is not None:
        from .parallel.mesh import world_rank

        if world_rank() != 0:
            # A `torchrun` rank other than 0 follows rank 0's dispatches.
            import torch.distributed as dist

            from .serving.ranks import follow

            follow()
            dist.destroy_process_group()
            return 0
    try:
        return _serve(args, cfg, followers)
    except BaseException:
        if followers is not None:
            followers.kill()
        raise


def _serve_world(args):
    """The world of a multi-device `serve`: its `Followers` (ranks
    1..n-1 started here, rank 0 being this process; none under
    `torchrun`, whose world is joined), or None for the single-process
    daemon (no `--n-devices` on the CPU or on a one-card machine)."""
    from .parallel.mesh import (
        Followers,
        backend_for,
        initialize_multihost,
        start_world,
    )
    from .serving.ranks import follow

    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        if args.device == "cuda":
            import torch

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        initialize_multihost(backend=backend_for(args.device))
        return Followers()
    n = _default_ranks(args)
    if args.n_devices is None and n == 1:
        return None
    try:
        return start_world(n, follow, device_type=args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: --n-devices {n}: {e}")


def _serve(args, cfg, followers) -> int:
    """`serve` on rank 0 (or alone): the daemon, until it drains."""
    import dataclasses
    import signal

    from .parallel.mesh import DEFAULT_TIMEOUT_S
    from .serving.daemon import SynthDaemon
    from .serving.excache import load_warmup_manifest
    from .utils.io import load_image
    from .utils.profiling import telemetry_session

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
    lattice_plan = None
    if args.lattice:
        from .serving.lattice import parse_lattice_spec, plan_lattice

        try:
            lattice_cfg = parse_lattice_spec(args.lattice)
        except ValueError as e:
            raise SystemExit(f"serve: {e}")
        if lattice_cfg is not None:
            lattice_plan = plan_lattice(lattice_cfg)
            lat = lattice_plan.lattice
            print(
                f"lattice[{lattice_plan.source}]: rungs "
                f"{list(lat.rungs)} x channels "
                f"{list(lat.config.channels)} = {lat.size} buckets "
                f"(growth {lat.growth:g}, "
                f"{len(lattice_plan.rejected)} candidate(s) rejected)",
                flush=True,
            )
    mesh = None
    if followers is not None:
        from .serving.ranks import ServingMesh

        # The data group's timeout is the dispatch's bound: a rank whose
        # peer failed waits no longer than that in a collective.
        try:
            mesh = ServingMesh(
                followers, a, ap, device_type=args.device,
                timeout_s=args.dispatch_deadline_s or DEFAULT_TIMEOUT_S,
            )
        except RuntimeError as e:
            raise SystemExit(f"serve: {e}")
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
            warm_dir=args.warm_dir,
            drain_deadline_s=args.drain_deadline_s,
            dispatch_deadline_s=args.dispatch_deadline_s,
            pipeline_window=args.pipeline_window,
            warmup_workers=args.warmup_workers,
            obs_interval_s=args.obs_interval_s,
            obs_capacity=args.obs_capacity,
            anomaly_config=anomaly_config,
            lattice=lattice_plan,
            archive_dir=args.archive_dir,
            archive_interval_s=args.archive_interval_s,
            mesh=mesh,
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
                how = ("disk-restored" if rec.get("verdict") == "disk"
                       else "first use")
                print(
                    f"warmup: {rec['key']} {how} in "
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
                "/sessions/adopt; GET /serving /slo /journal /obs/window "
                "/request /incidents /archive /metrics /metrics.json "
                "/healthz /progress)",
                flush=True,
            )
            while not daemon.drained.wait(1.0):
                pass
            print("serve: drained, exiting", flush=True)
        except KeyboardInterrupt:
            print("serve: interrupted, draining")
        finally:
            # Past the drain a SIGTERM has nothing left to do; ignored,
            # it cannot kill the exit once the interpreter's shutdown
            # has put the default action back.
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            daemon.stop()
            codes = mesh.close() if mesh is not None else []
    if daemon.world_lost is not None:
        print(f"serve: the serving world lost a rank "
              f"({daemon.world_lost}); drained, the journal kept for "
              "serve --takeover", file=sys.stderr)
        return 1
    if any(c != 0 for c in codes):
        print(f"serve: ranks 1..{len(codes)} exited with {codes}",
              file=sys.stderr)
        return 1
    return 0


# The reconstruction bound `trace` checks: the phases of a dispatched
# request explain its end-to-end latency to within this share.
TRACE_GAP_PCT_MAX = 5.0


def _cmd_trace_fleet(args) -> int:
    """`trace ID --fleet DISCOVERY`: the one-command cross-process
    waterfall.  Walks the router's discovery file, asks every process
    `GET /request?id=`, joins the router's and the replica's records by
    the forwarded span context, and renders one waterfall with the
    clock-skew bound and the honest unattributed gap."""
    import json

    from .serving.fleettrace import (
        fetch_fleet_trace,
        join_fleet_trace,
        render_fleet_waterfall,
    )
    from .serving.router import load_discovery

    try:
        discovery = load_discovery(args.fleet)
    except (OSError, ValueError) as e:
        raise SystemExit(f"trace: discovery file {args.fleet}: {e}")
    fetched = fetch_fleet_trace(discovery, args.request_id, timeout=10.0)
    router_doc = fetched.get("router") or {}
    router_rec = router_doc.get("request")
    replica_recs = []
    replica_events = {}
    for rep in fetched.get("replicas") or []:
        doc = rep.get("doc") or {}
        rec = doc.get("request")
        if rec is not None:
            replica_recs.append(rec)
            replica_events[str(rep.get("name"))] = (
                doc.get("flight_events") or []
            )
    if router_rec is None and not replica_recs:
        detail = "; ".join(fetched.get("errors") or [])
        raise SystemExit(
            f"trace: request {args.request_id!r} unknown to every "
            "process in the discovery file"
            + (f" ({detail})" if detail else "")
        )
    joined = join_fleet_trace(
        router_rec, replica_recs, args.request_id,
        router_events=router_doc.get("flight_events") or [],
        replica_events=replica_events,
    )
    if fetched.get("errors"):
        joined.setdefault("notes", []).extend(
            f"unreachable mid-fetch: {e}" for e in fetched["errors"]
        )
    if args.format == "json":
        print(json.dumps(joined, indent=1))
    else:
        print(render_fleet_waterfall(joined))
    return 0


def cmd_trace(args) -> int:
    """Reconstruct one served request's critical path: the access log
    is the source of truth for phase attribution (queue/compile/
    execute/demux ms the daemon booked at response time), joined, when
    the artifacts exist, with the request's `serve_request` span tree
    from flight.json.  `--url` asks a live daemon instead (GET
    /request?id=); `--fleet DISCOVERY` walks the router's discovery
    file and joins the router's and the replica's records into one
    waterfall (`_cmd_trace_fleet`).  Prints a phase-attributed
    waterfall; exits nonzero when the id is unknown, and 1 when a
    dispatched request's phases leave more than TRACE_GAP_PCT_MAX
    percent of its latency unexplained."""
    import json

    from .serving.accesslog import phase_fields

    if sum(map(bool, (args.url, args.trace_dir, args.fleet))) != 1:
        raise SystemExit(
            "trace: exactly one of --url (live daemon), --trace-dir "
            "(post-mortem artifacts) or --fleet (router discovery "
            "file) is required"
        )
    if args.fleet:
        return _cmd_trace_fleet(args)
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


def cmd_obs(args) -> int:
    """The fleet observatory: scrape every target daemon's /metrics.json + /slo + /obs/window, pool the
    registries (sum counters, merge histogram buckets — fleet burn
    rates are request-weighted, never replica-averaged), render the
    terminal dashboard, and optionally write the OBS record
    tools/check_obs.py validates.  Exits 1 when no target answered or
    the pooled SLO verdict is violated."""
    import json

    from .serving.observatory import (
        aggregate,
        parse_targets,
        render_dashboard,
        write_obs,
    )

    try:
        targets = parse_targets(args.targets)
    except ValueError as e:
        raise SystemExit(f"obs: {e}")
    record = aggregate(targets, span_s=args.span, timeout=args.timeout)
    if args.format == "json":
        print(json.dumps(record, indent=1))
    else:
        print(render_dashboard(record), end="")
    if args.out:
        write_obs(record, args.out)
        print(f"obs: wrote {args.out}", file=sys.stderr)
    fleet = record.get("fleet") or {}
    if not fleet.get("replicas_live"):
        print("obs: no live replicas", file=sys.stderr)
        return 1
    if (fleet.get("slo") or {}).get("verdict") == "violated":
        return 1
    return 0


def cmd_history(args) -> int:
    """Restart-lineage view over a durable telemetry archive
    (telemetry/archive.py): group the archived snapshots by boot,
    summarize each boot's window (obs generation span, SLO verdict,
    latency p99, the anomaly baseline it graded against), diff
    consecutive boots, and list the incidents captured along the way.
    With --targets, each live endpoint is probed too — an endpoint
    that is down while its archive is present renders FROM THE
    ARCHIVE with an explicit degraded-fleet warning, never a silent
    drop.  Exits 1 only when the archive itself holds no records."""
    import json
    import urllib.error
    import urllib.request
    from collections import OrderedDict

    from .telemetry.archive import list_incidents, read_archive_entries

    boots = OrderedDict()
    records = 0
    for rec in read_archive_entries(args.archive_dir):
        records += 1
        bid = rec.get("boot_id")
        if not isinstance(bid, str):
            continue
        boot = boots.setdefault(bid, {
            "boot_id": bid, "first_ts": rec.get("ts"),
            "last_ts": rec.get("ts"), "snapshots": 0,
            "incidents": [], "generation": None, "baseline": None,
            "verdict": None, "p99_ms": None, "final": False,
        })
        boot["last_ts"] = rec.get("ts", boot["last_ts"])
        kind = rec.get("kind")
        if kind == "snapshot":
            boot["snapshots"] += 1
            g = rec.get("obs_generation")
            if isinstance(g, int):
                boot["generation"] = g
            b = rec.get("anomaly_baseline_p99_ms")
            if isinstance(b, (int, float)):
                boot["baseline"] = float(b)
            boot["final"] = bool(rec.get("final"))
            slo = rec.get("slo") or {}
            boot["verdict"] = slo.get("verdict", boot["verdict"])
            lat = next(
                (o for o in slo.get("objectives", [])
                 if o.get("kind") == "latency"), None,
            )
            if lat and lat.get("observed_p99_ms") is not None:
                boot["p99_ms"] = float(lat["observed_p99_ms"])
        elif kind == "incident":
            boot["incidents"].append(rec.get("id"))
    warnings = []
    if getattr(args, "targets", None):
        from .serving.observatory import parse_targets

        try:
            targets = parse_targets(args.targets)
        except ValueError as e:
            raise SystemExit(f"history: {e}")
        for t in targets:
            try:
                with urllib.request.urlopen(
                    f"{t}/healthz", timeout=args.timeout
                ):
                    pass
            except (urllib.error.URLError, OSError) as e:
                warnings.append(
                    f"target {t} unreachable ({type(e).__name__}: "
                    f"{e}); history rendered from the archive only"
                )
    incidents = list_incidents(args.archive_dir)
    if args.format == "json":
        print(json.dumps({
            "archive_dir": args.archive_dir,
            "records": records,
            "boots": list(boots.values()),
            "incidents": incidents,
            "warnings": warnings,
        }, indent=1))
        return 0 if boots else 1
    print(
        f"telemetry history — {args.archive_dir}: "
        f"{len(boots)} boot(s), {records} record(s), "
        f"{len(incidents)} incident bundle(s)"
    )
    prev = None
    for boot in boots.values():

        def _ts(v):
            return (
                time.strftime("%H:%M:%S", time.gmtime(v))
                if isinstance(v, (int, float)) else "-"
            )

        p99 = boot["p99_ms"]
        base = boot["baseline"]
        print(
            f"boot {boot['boot_id']:<22} "
            f"{_ts(boot['first_ts'])}→{_ts(boot['last_ts'])}  "
            f"snaps={boot['snapshots']:<4} "
            f"gen={boot['generation'] if boot['generation'] is not None else '-':<4} "
            f"verdict={boot['verdict'] or '-':<9} "
            f"p99={f'{p99:.1f}ms' if p99 is not None else '-':<10} "
            f"baseline={f'{base:.1f}ms' if base is not None else '-'}"
            + ("  [drained]" if boot["final"] else "")
        )
        for inc in boot["incidents"]:
            print(f"  incident {inc}")
        if prev is not None:
            pp, np_ = prev["p99_ms"], boot["p99_ms"]
            carried = (
                prev["baseline"] is not None
                and boot["baseline"] == prev["baseline"]
            ) or (
                prev["p99_ms"] is None and boot["baseline"] is not None
            )
            diff = (
                f"p99 {pp:.1f}→{np_:.1f}ms"
                if pp is not None and np_ is not None else "p99 -"
            )
            print(
                f"  ↳ restart diff vs {prev['boot_id']}: {diff}, "
                f"baseline "
                + ("carried" if boot["baseline"] is not None
                   else "absent")
            )
        prev = boot
    for warn in warnings:
        print(f"WARNING (fleet degraded): {warn}")
    if not boots:
        print("history: archive holds no records", file=sys.stderr)
        return 1
    return 0


def cmd_incident(args) -> int:
    """Render one black-box incident bundle: the trigger,
    the config/backend fingerprint, the graded SLO objectives and
    anomaly watches at capture time, the access-log tail, and the
    slowest tail request's phase waterfall — from the archive dir on
    disk, or proxied live from a daemon/router URL."""
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    from .serving.accesslog import phase_fields

    doc = None
    if bool(args.url) == bool(args.archive_dir):
        raise SystemExit(
            "incident: exactly one of --archive-dir (on disk) or "
            "--url (live daemon/router) is required"
        )
    if args.url:
        base = args.url.rstrip("/")
        if not base.startswith(("http://", "https://")):
            base = "http://" + base
        q = urllib.parse.quote(args.incident_id, safe="")
        try:
            with urllib.request.urlopen(
                f"{base}/incidents?id={q}", timeout=10.0
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            raise SystemExit(
                f"incident: {args.incident_id!r}: endpoint answered "
                f"{e.code}"
            )
        except (urllib.error.URLError, OSError) as e:
            raise SystemExit(f"incident: cannot reach {args.url}: {e}")
    else:
        from .telemetry.archive import load_incident

        doc = load_incident(args.archive_dir, args.incident_id)
        if doc is None:
            raise SystemExit(
                f"incident: {args.incident_id!r} not found under "
                f"{args.archive_dir}/incidents"
            )
    if args.format == "json":
        print(json.dumps(doc, indent=1))
        return 0
    trig = doc.get("trigger") or {}
    print(
        f"incident {doc.get('id')}  trigger={trig.get('kind')}  "
        f"ts={doc.get('ts')}"
    )
    if trig.get("watches"):
        print(f"  watches firing: {', '.join(trig['watches'])}")
    for o in trig.get("objectives") or []:
        print(
            f"  objective {o.get('name')}: {o.get('status')} "
            f"(burn={o.get('burn_rate')})"
        )
    fp = doc.get("fingerprint") or {}
    print(
        f"  daemon: pid={fp.get('pid')} backend={fp.get('backend')} "
        f"devices={fp.get('devices')} boot={fp.get('boot_id')}"
    )
    slo = doc.get("slo") or {}
    print(f"  slo verdict at capture: {slo.get('verdict', '-')}")
    for o in slo.get("objectives") or []:
        burn = o.get("burn_rate")
        print(
            f"    {o.get('name'):<24} {o.get('status'):<10} "
            f"burn={'-' if burn is None else f'{burn:.4f}'}"
        )
    anom = doc.get("anomaly") or {}
    if anom:
        print(
            f"  anomaly verdict: {anom.get('verdict', '-')} "
            f"(firing: "
            f"{', '.join(anom.get('firing') or []) or 'none'})"
        )
    flight = doc.get("flight") or {}
    if flight:
        print(
            f"  flight: {len(flight.get('events') or [])} span "
            f"event(s) in ring, flushed_on="
            f"{flight.get('flushed_on')}"
        )
    tail = doc.get("access_tail") or []
    print(f"  access tail: {len(tail)} request(s)")
    for rec in tail[-args.tail:]:
        print(
            f"    {str(rec.get('request_id')):<24} "
            f"{str(rec.get('outcome')):<9} "
            f"http={rec.get('http_status')} "
            f"total={rec.get('total_ms')}ms"
        )
    served = [r for r in tail if r.get("total_ms") is not None]
    if served:
        worst = max(served, key=lambda r: float(r["total_ms"]))
        total_ms = float(worst.get("total_ms") or 0.0)
        print(
            f"  slowest tail request {worst.get('request_id')} "
            f"({total_ms:.3f} ms):"
        )
        width = 32
        for name, ms in phase_fields(worst):
            frac = ms / total_ms if total_ms > 0 else 0.0
            bar = ("#" * max(1, int(round(frac * width)))
                   if ms > 0 else "")
            print(f"    {name:8s} {ms:10.3f} ms  "
                  f"{100.0 * frac:5.1f}%  {bar}")
    return 0


def cmd_route(args) -> int:
    """Fleet router (serving/router.py): spread POST /synthesize across
    N daemon replicas — least outstanding work with queue-depth
    awareness from each replica's /serving snapshot, session affinity
    for video streams, drain-time session migration — and keep a
    replica-discovery file current for `obs`.  With --trace-dir, every
    proxied request gets a span tree (received/pick/proxy_attempt/
    respond) in the router's flight ring, a line in the router's own
    access.jsonl, and the `X-Parent-Span`/`X-Trace-Hop` headers it
    forwards join the replica's serve_request tree to this hop
    (`trace ID --fleet DISCOVERY`).  Pure coordination over HTTP: this
    process touches no tensor and never initialises CUDA."""
    import signal as _signal
    import threading

    from .serving.router import FleetRouter
    from .utils.profiling import telemetry_session

    try:
        from .serving.observatory import parse_targets

        targets = parse_targets(args.targets)
    except ValueError as e:
        raise SystemExit(f"route: {e}")
    with telemetry_session(
        None, enabled=True, artifact_dir=args.trace_dir,
        metrics_port=None,
    ) as tracer:
        router = FleetRouter(
            tracer.registry,
            tracer=tracer,
            host=args.host,
            port=args.port,
            poll_interval_s=args.poll_interval_s,
            discovery_path=args.discovery_out,
            proxy_timeout_s=args.proxy_timeout_s,
            flight=getattr(tracer, "flight_recorder", None),
            access_log_path=(
                os.path.join(args.trace_dir, "access.jsonl")
                if args.trace_dir else None
            ),
        ).start()
        stop = threading.Event()
        _signal.signal(_signal.SIGTERM, lambda *_: stop.set())
        try:
            for url in targets:
                handle = router.add_replica(url)
                state = "up" if handle.alive else "DOWN"
                print(f"route: replica {handle.name} {handle.url} "
                      f"[{state}]")
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
                router.live.announce(args.trace_dir)
            print(
                f"routing on {router.url} (POST /synthesize "
                "/replicas/add /replicas/remove /drain_replica; GET "
                "/fleet /replicas /request /slo /metrics /metrics.json "
                "/healthz)",
                flush=True,
            )
            if args.discovery_out:
                print(f"route: discovery file at {args.discovery_out} "
                      "(pass to `obs --targets` and "
                      "`trace --fleet`)")
            while not stop.wait(1.0):
                pass
            print("route: exiting", flush=True)
        except KeyboardInterrupt:
            print("route: interrupted")
        finally:
            # As serve's: a later SIGTERM cannot kill the exit.
            _signal.signal(_signal.SIGTERM, _signal.SIG_IGN)
            router.stop()
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
    p.add_argument(
        "--n-devices", type=int, default=None,
        help="shard the frames over this many ranks (the command starts "
        "them itself; video: with --warm off only)")
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
    mode.add_argument(
        "--spatial", action="store_true",
        help="shard B' rows over the ranks (row slabs with halos); "
        "with --bands also A ownership bands (2-D bands x slabs mesh)")
    mode.add_argument(
        "--sharded-a", action="store_true",
        help="band-shard the A side (lean tables and K1 planes) over "
        "the ranks")
    p.add_argument(
        "--n-devices", type=int, default=None,
        help="ranks of a --spatial / --sharded-a run (default: every "
        "card, or 1 on the CPU); the command starts them itself")
    p.add_argument(
        "--bands", "--mesh-rows", dest="bands", type=int, default=None,
        help="--spatial: A bands of the 2-D mesh (must divide the "
        "device count; default: the mesh planner's choice)")
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
                   help="not ported yet (ROADMAP Queue 1 step 14b, "
                   "multi-device serving)")
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
        help="fleet-shared warm tier: N replicas of one config root "
        "their warm tier (DIR/excache/index.json, the shapes the fleet "
        "has served) and the observed-warmup union here, merged on "
        "every write; a new replica dispatches every sealed shape "
        "before its endpoint announces (journal, lock and sessions "
        "stay per replica in --state-dir).  Default: the state dir",
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
        help="durable telemetry archive + black box: observatory "
        "windows, SLO state and anomaly baselines persist to DIR as "
        "segmented JSONL (atomic sealing, torn-tail-tolerant reload), "
        "so a restart with the same DIR resumes its anomaly watches "
        "against the pre-restart baselines; an SLO fast_burn or a "
        "firing watch captures one incident bundle under "
        "DIR/incidents (rate-limited, disk-budgeted; GET /incidents, "
        "`history`, `incident <id>`)",
    )
    p.add_argument(
        "--archive-interval-s", type=float, default=30.0, metavar="S",
        help="archive snapshot cadence (default 30; <= 0 keeps the "
        "archive open for boot/drain records and incidents but skips "
        "the periodic snapshots)",
    )
    p.add_argument(
        "--flight-ring", type=int, default=None, metavar="N",
        help="flight-recorder event-ring capacity (default: "
        "IA_FLIGHT_RING env or 512; memory scales linearly, "
        "~200-500 bytes per event)",
    )
    p.add_argument(
        "--lattice", default=None, metavar="SPEC",
        help="shape-lattice admission: sessionless frames are edge-"
        "padded up to the smallest bucket of a geometric grid at "
        "admission and cropped back at demux, so the executable keys "
        "are bounded by the lattice, and warmup dispatches every "
        "bucket before the endpoint announces.  SPEC: off (default) | "
        "on (32:512, planner-chosen growth) | MIN:MAX (planner-chosen "
        "growth) | MIN:MAX:GROWTH.  Frames over the top rung bypass to "
        "the exact-key path; a takeover successor must run the same "
        "spec for bit-identical journal replay",
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
        "--trace-dir/--url/--fleet",
    )
    p.add_argument(
        "--fleet", default=None, metavar="DISCOVERY",
        help="cross-process waterfall: walk the router's discovery "
        "file (route --discovery-out), pull the router-side and "
        "replica-side records for this id, join them by the forwarded "
        "X-Parent-Span context, and render one waterfall with a "
        "clock-skew bound and an honest unattributed gap; exactly one "
        "of --trace-dir/--url/--fleet",
    )
    p.add_argument(
        "--access-log", default=None, metavar="JSONL",
        help="explicit access-log path (default: "
        "<trace-dir>/access.jsonl)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "route",
        help="fleet router: spread POST /synthesize across N serve "
        "replicas with session affinity, queue-aware least-"
        "outstanding routing, drain-time session migration, and a "
        "discovery file for `obs`",
    )
    _add_common_flags(p)
    p.add_argument(
        "--targets", required=True, metavar="HOST:PORT,... | FILE",
        help="initial replica endpoints: comma-separated host:port / "
        "http:// URLs, or an existing discovery file (replicas can "
        "also join later via POST /replicas/add)",
    )
    p.add_argument(
        "--port", type=int, default=0,
        help="router bind port (0 = ephemeral; announces in "
        "<trace-dir>/live.json when --trace-dir is set)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--poll-interval-s", type=float, default=0.5, metavar="S",
        help="replica /serving scrape cadence feeding the queue-"
        "depth-aware routing scores (default 0.5)",
    )
    p.add_argument(
        "--proxy-timeout-s", type=float, default=600.0, metavar="S",
        help="per-proxy HTTP timeout (default 600 — must outlast a "
        "cold compile on the slowest replica)",
    )
    p.add_argument(
        "--discovery-out", default=None, metavar="JSON",
        help="replica-discovery file, rewritten atomically on every "
        "membership/drain change; `obs --targets FILE` "
        "scrapes exactly this fleet",
    )
    p.add_argument(
        "--trace-dir", default=None, metavar="DIR",
        help="announce the router endpoint in DIR/live.json",
    )
    p.set_defaults(fn=cmd_route)

    p = sub.add_parser(
        "obs",
        help="multi-replica serving observatory: scrape N daemons' "
        "/metrics.json + /slo + /obs/window, pool registries into "
        "fleet burn rates, render a dashboard, write OBS json",
    )
    _add_common_flags(p)
    p.add_argument(
        "--targets", required=True, metavar="HOST:PORT,HOST:PORT,...",
        help="comma-separated daemon endpoints (host:port or full "
        "http:// URLs)",
    )
    p.add_argument(
        "--span", type=float, default=None, metavar="S",
        help="window span (seconds) requested from each replica's "
        "/obs/window (default: each replica's whole ring)",
    )
    p.add_argument(
        "--timeout", type=float, default=10.0, metavar="S",
        help="per-scrape HTTP timeout (default 10)",
    )
    p.add_argument(
        "--out", default=None, metavar="JSON",
        help="write the OBS record here (the artifact "
        "tools/check_obs.py validates)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_obs)

    p = sub.add_parser(
        "history",
        help="restart-lineage view over a durable telemetry archive: "
        "per-boot window summaries, cross-restart diffs, incident "
        "index",
    )
    _add_common_flags(p)
    p.add_argument(
        "--archive-dir", required=True, metavar="DIR",
        help="the daemon's --archive-dir (segmented archive.jsonl + "
        "incidents/ live here)",
    )
    p.add_argument(
        "--targets", default=None, metavar="HOST:PORT,... | FILE",
        help="optionally probe these live endpoints too (same "
        "grammar as `obs --targets`, discovery files "
        "included); an endpoint that is down while its archive is "
        "present renders from the archive with a degraded-fleet "
        "warning, never a silent drop",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0, metavar="S",
        help="per-probe HTTP timeout (default 5)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser(
        "incident",
        help="render one black-box incident bundle: trigger, "
        "fingerprint, SLO/anomaly state at capture, access-log tail "
        "+ slowest-request waterfall",
    )
    _add_common_flags(p)
    p.add_argument(
        "incident_id",
        help="the bundle id (from `history`, GET "
        "/incidents, or the incidents/ directory)",
    )
    p.add_argument(
        "--archive-dir", default=None, metavar="DIR",
        help="read the bundle from DIR/incidents on disk; exactly "
        "one of --archive-dir/--url",
    )
    p.add_argument(
        "--url", default=None, metavar="URL",
        help="fetch the bundle live from a daemon or router "
        "(GET /incidents?id=); exactly one of --archive-dir/--url",
    )
    p.add_argument(
        "--tail", type=int, default=10, metavar="N",
        help="access-tail rows to print (default 10)",
    )
    p.add_argument("--format", default="table", choices=["table", "json"])
    p.set_defaults(fn=cmd_incident)

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

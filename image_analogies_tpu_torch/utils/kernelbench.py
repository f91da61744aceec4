"""K1 microbench harness: the port's counterpart of the reference's
`utils/kernelbench.py`, timing one steady-state tile sweep three ways on
the same setup, so their figures measure the same kernel by construction:

  - `sweep_time_ms`: CUDA events around N and 2N sweeps launched from
    the host, differenced (the constant cost of the closing event and
    sync cancels);
  - `sweep_time_device_loop_ms`: a CUDA graph of N sweeps replayed, the
    min over `reps` replays, N against 2N: the counterpart of the
    reference's on-device `fori_loop`, with no host launch between
    sweeps;
  - `sweep_time_trace_ms`: the `tile_sweep_kernel` device time in a
    `torch.profiler` trace (`utils/torch_trace.py`), the instrument the
    run sentinel's `check_instrument_drift` holds the loop figure to.

Kernels run only on the card: the setup's tensors are CUDA tensors, and
every timing function raises without a card.
"""

from __future__ import annotations

import numpy as np
import torch


def sweep_setup(cfg, size: int, device="cuda"):
    """A steady-state tile sweep at the (size x size) level geometry of
    `cfg` (the level's channels with the coarse pair, one A band).

    Returns (one_iter, state0, meta): `one_iter(oy, ox, d)` runs one
    sweep, `state0` the incoming compact state, `meta` the setup's
    description (with the sweep's arguments, `args` and `kw`, as
    `tile_sweep` takes them).  The candidate tables come from a RANDOM field, so a
    slot dedups away only where the geometry makes two slots coincide:
    the last tile column's padding past the image repeats its edge
    offsets, so its own samples there coincide, and so do the slots its
    samples propagate to in its two neighbour columns (the first one by
    wrap-around); every other tile evaluates all 36 slots (counted in
    `meta["valid_slots"]`).
    Under the module's PCA prune "K:M" only the first M slots stay
    valid, as the compressed path's budget.  Returns None when the
    geometry is kernel-ineligible."""
    from ..config import engine_modes
    from ..kernels import patchmatch_tile as pt

    dev = torch.device(device)
    plan = pt.plan_channels(1, 1, cfg, True, size, size, size, size)
    if plan is None:
        return None
    specs, use_coarse = plan
    geom = pt.tile_geometry(size, size, specs)
    rng = np.random.default_rng(0)

    def mk(*shape):
        return torch.as_tensor(rng.random(shape, dtype=np.float32),
                               device=dev)

    half = size // 2
    coarse = (mk(half, half), mk(half, half)) if use_coarse else (None, None)
    a_planes = pt.prepare_a_planes(mk(size, size), mk(size, size), *coarse,
                                   specs)
    coarse = (mk(half, half), mk(half, half)) if use_coarse else (None, None)
    b_planes = pt.prepare_b_planes(mk(size, size), mk(size, size), *coarse,
                                   geom)
    q = torch.arange(size, device=dev)
    py = torch.as_tensor(rng.integers(0, size, (size, size)), device=dev)
    px = torch.as_tensor(rng.integers(0, size, (size, size)), device=dev)
    oy = pt.to_compact((py - q[:, None]).to(torch.int32), geom)
    ox = pt.to_compact((px - q[None, :]).to(torch.int32), geom)
    d = torch.full(oy.shape, float("inf"), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cand_y, cand_x, cand_valid = pt.sample_candidates_blocked(
        oy, ox, pt.draw_candidates(gen, geom, size, size), geom, size, size)
    modes = engine_modes()
    prune = pt.parse_prune(modes.prune)
    if prune is not None:
        keep = torch.arange(pt.K_TOTAL, device=dev) < prune[1]
        cand_valid = (cand_valid * keep).to(torch.int32).contiguous()
    budget = prune[1] if prune else None
    kw = dict(specs=specs, geom=geom, ha=size, wa=size, coh_factor=1.0)

    def one_iter(oy, ox, d):
        return pt.tile_sweep(a_planes, b_planes, cand_y, cand_x, cand_valid,
                             oy, ox, d, cand_budget=budget, **kw)

    rows = pt.sweep_plan(len(specs), geom.halo)
    meta = {
        "args": (a_planes, b_planes, cand_y, cand_x, cand_valid, oy, ox, d),
        "kw": kw,
        "size": size,
        "specs": specs,
        "geom": geom,
        "n_chan": len(specs),
        "strip_rows": rows,
        "cand_dtype": modes.cand_dtype,
        "prune": prune,
        "valid_slots": int((cand_valid > 0).sum()),
        "slots": cand_valid.numel(),
        "window_bytes": pt.window_bytes(cand_valid, specs, geom,
                                        a_planes.element_size()),
    }
    return one_iter, (oy, ox, d), meta


def _events_ms(fn) -> float:
    """Milliseconds of `fn()` on the current stream, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def sweep_time_ms(cfg, size: int, iters: int = 16):
    """(ms per sweep, meta): N and 2N sweeps launched from the host,
    each timed by CUDA events, differenced; None when ineligible."""
    setup = sweep_setup(cfg, size)
    if setup is None:
        return None
    one_iter, s0, meta = setup
    one_iter(*s0)  # warm: the build, the weights' first copy
    torch.cuda.synchronize()

    def run(n):
        s = s0
        for _ in range(n):
            s = one_iter(*s)

    t_n = _events_ms(lambda: run(iters))
    t_2n = _events_ms(lambda: run(2 * iters))
    return (t_2n - t_n) / iters, meta


def sweep_time_device_loop_ms(cfg, size: int, iters: int = 24,
                              reps: int = 5):
    """(ms per sweep, meta) from CUDA graphs of N and 2N sweeps: each
    graph replayed `reps` times, the min replay time (a stall only adds
    time) of each, differenced.  The state is carried from sweep to
    sweep inside the graph, so no sweep can be elided or overlapped.  A
    failed capture raises; None when ineligible."""
    setup = sweep_setup(cfg, size)
    if setup is None:
        return None
    one_iter, s0, meta = setup
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        one_iter(*s0)  # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def capture(n):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            s = s0
            for _ in range(n):
                s = one_iter(*s)
        return graph

    graphs = {n: capture(n) for n in (iters, 2 * iters)}
    best = {}
    for n, graph in graphs.items():
        graph.replay()  # warm
        torch.cuda.synchronize()
        best[n] = min(_events_ms(graph.replay) for _ in range(reps))
    return (best[2 * iters] - best[iters]) / iters, meta


def sweep_time_trace_ms(cfg, size: int, iters: int = 16,
                        trace_dir: str = None):
    """(ms per sweep, meta, {device op: total ms}): `iters` sweeps under
    `torch.profiler` with CUDA activity (after a warm sweep), the trace
    written to `trace_dir` (a temporary directory when None) and read
    back through `utils/torch_trace.py`; the sweep time is the
    `tile_sweep_kernel` device time over `iters`.  None when
    ineligible.  Raises unless the trace holds exactly `iters`
    `tile_sweep_kernel` events: a profiler session in a process that ran
    earlier ones has been seen to record only some of them, or none
    (PERF.md), so run the bench in a fresh process (`main`)."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from .torch_trace import TRACE_FILE, load_events, summarize

    setup = sweep_setup(cfg, size)
    if setup is None:
        return None
    one_iter, s, meta = setup
    s = one_iter(*s)
    torch.cuda.synchronize()
    d = trace_dir or tempfile.mkdtemp(prefix="kernelbench_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                s = one_iter(*s)
            torch.cuda.synchronize()
        prof.export_chrome_trace(f"{d}/{TRACE_FILE}")
        events = load_events(f"{d}/{TRACE_FILE}")
    finally:
        if trace_dir is None:
            shutil.rmtree(d, ignore_errors=True)
    per_op: dict = {}
    for ops in summarize(events)["planes"].values():
        for name, ms in ops.items():
            per_op[name] = per_op.get(name, 0.0) + ms
    n_k1 = sum(1 for ev in events if ev.get("cat") == "kernel"
               and "tile_sweep_kernel" in str(ev.get("name")))
    if n_k1 != iters:
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:3]
        raise RuntimeError(
            f"the profiler trace of {iters} sweeps holds {n_k1} "
            f"tile_sweep_kernel events ({len(per_op)} device ops, the "
            f"longest {top})")
    sweep = sum(ms for name, ms in per_op.items()
                if "tile_sweep_kernel" in name)
    return sweep / iters, meta, per_op


def main(argv=None) -> int:
    """`python -m image_analogies_tpu_torch.utils.kernelbench [--size N]`:
    one K1 bench record at the default config's level geometry on the
    card, as one JSON line: the three instruments, the sentinel's
    `check_instrument_drift` on them, and the setup's slots and bytes."""
    import argparse
    import json

    from ..config import SynthConfig
    from ..telemetry.sentinel import check_instrument_drift

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    cfg = SynthConfig()
    trace_ms, meta, _ = sweep_time_trace_ms(cfg, args.size, args.iters,
                                            trace_dir=args.trace_dir)
    events_ms, _ = sweep_time_ms(cfg, args.size, args.iters)
    loop_ms, _ = sweep_time_device_loop_ms(cfg, args.size)
    rec = {"kernel_sweep_ms_events": events_ms,
           "kernel_sweep_ms_loop": loop_ms,
           "kernel_sweep_ms_trace": trace_ms}
    rec["instrument_drift"] = check_instrument_drift(rec)
    rec.update({k: meta[k] for k in ("size", "n_chan", "strip_rows",
                                     "cand_dtype", "prune", "valid_slots",
                                     "slots", "window_bytes")})
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

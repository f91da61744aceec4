"""Chip smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

    python3 chip_smoke.py --phases k1,k1i8,k2,config1   # K1 and K2 only

    python3 chip_smoke.py --phases lean   # 2048^2 and 4096^2 only

    python3 chip_smoke.py --phases batch,video   # config 5 and video

    python3 chip_smoke.py --phases cli   # the command line, configs 2, 4

    python3 chip_smoke.py --phases telemetry   # sentinel, live, report, bench

    python3 chip_smoke.py --phases serve   # serve + trace

    python3 chip_smoke.py --phases fleet   # route, obs, history, incident

    python3 chip_smoke.py --phases multi   # K1 banded, sharded-A, spatial

Builds the port's CUDA kernels from `image_analogies_tpu_torch/kernels/
csrc/`, holds each kernel against its plain PyTorch version at the main
path's shapes (K1 in float32 and int8 mode, on a seeded case and on the
tables and state of the headline's first level-0 sweep; K2 on float32
and bfloat16 rows, at 65,536^2 x 68 and at a ragged 10,007 x 9,001 x
150; K3 on bf16 and int8 tables; K4, one cascade sweep, at the 64^2
per-pixel level's float32 rows and the 1024^2 polish's bf16 rows, with
its launches a headline run), drives the main paths through
`create_image_analogy` (the 1024^2 super-resolution headline with
PatchMatch; the same headline with compressed candidates, int8 + PCA
prune 16:8, and the streamed, sequential and jump polish engines; and
texture-by-numbers at 256^2 with the brute oracle, in float32 and
bfloat16; the lean path at 2048^2 and 4096^2 with the repo's scale
config, against the standard path, the lean-brute oracle and a resume
from a checkpoint, with K1, K2 and K3 held against their plain versions
at the lean shapes; BASELINE config 5, 8 frames of 1024^2 with 4
resident, through `synthesize_batch` against its brute oracle, with K1
sweeping the resident frames in one launch; the video bench's cold,
warm, warm-with-tau and oracle passes at 1024^2 through `VideoStream`;
the command line in subprocesses, `python -m image_analogies_tpu_torch.cli`,
on assets its `examples` wrote: the headline with its telemetry
directory, progress stream and torch.profiler trace, the ann matcher,
and `--supervise` under injected faults, beside BASELINE configs 2 and
4 against their brute oracles with K1 at steerable width; and the
telemetry layer: the headline through `synth` with `--health` and
`--metrics-port`, its live exporter scraped while it runs, `health` and
`report` on its directory, the compressed arm's three byte ledgers, the
telemetry layers' overhead and the K1 bench; and the serving daemon:
`serve` processes on config 5's frames at 1024^2, grain 4, swept at 1
and 8 clients and past their depth limit, every answer bit-equal to
the library's grain-4 dispatch, a session against `VideoStream`,
and `trace`; and the serving fleet:
`serve` replicas on one warm dir and a shape lattice behind `route`,
swept at 4 and 8 clients, never-seen shapes and a bypass, a replica
joining warm, a session drained and adopted, `obs` and `trace --fleet`,
and at 256^2 a replica SIGKILLed mid-burst, its takeover, the telemetry
archive across restarts and a torn append, `history` and `incident`;
and the multi-device runners: K1's banded mode at the headline's
level-0 shapes in float32 and int8 over 2 and 4 bands, against its plain
version and as a band sequence against one launch, the sharded-A
headline over NCCL at world size 1 and over gloo with two ranks on
cuda:0, and the spatial runner at world size 1 and through `synth
--spatial --n-devices 1`, each bit-identical to its single-device B'),
checks the outputs and their PSNR against the brute oracle, and the
batch and video runners' isolation and gates, and prints one JSON line
per phase, each with its `seconds` (also appended to
`chiprun_out/chip_smoke.jsonl`, with the serve phase's SERVE record in
`chiprun_out/serve_record.json` and the fleet phase's records, each
held to its tools/check_*.py validator's checks, in
`chiprun_out/fleet_*.json`).  The line before the last is the
`kernels` summary; the last is `{"ok": true, "device": {...}}`.  Any
failed phase raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device.

Bounds (`bound_ms`) use the H100 SXM's published peaks: 67 TFLOP/s of
FP32 on the CUDA cores, 495 TFLOP/s of TF32 and 989 TFLOP/s of bf16 on
the tensor cores, and 3.35 TB/s of HBM.  K2's float32 rows go through
three TF32 products per pair, so their bound is 3 * 2 N_B N_A D_pad FLOP
at the TF32 peak.  K1 also reports `l2_floor_ms`: the A-window bytes a
launch pulls from L2 over the L2 read rate measured in the same run.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
PHASES = ("k1", "k2", "k3", "k4", "k1i8", "headline", "compressed",
          "config1", "quality", "profile", "lean", "batch", "video", "cli",
          "telemetry", "serve", "fleet", "multi", "serve_multi")
HEADLINE = dict(levels=5, matcher="patchmatch", em_iters=2, pm_iters=6,
                pm_polish_iters=1, device="cuda")


# K2's tie rule on real feature tables: two picks tie when their exact
# float32 distances agree within 1e-5 relative, or within the float32
# resolution of the expansion both versions minimize, a_sq - 2 b.a: its
# terms are of the size of ||a||^2 + ||b||^2, which on features of
# neighbouring pixels is a thousand times the distance itself, so sums
# taken in another order cannot tell such rows apart.
K2_TIE_RTOL = 1e-5
K2_TIE_ULPS = 8


def k2_resolution(f_b, f_a, idx):
    """`K2_TIE_ULPS` float32 ulps of ||a||^2 + ||b||^2 per query row."""
    fa = f_a.float().index_select(0, idx)
    scale = (fa * fa).sum(-1) + (f_b.float() * f_b.float()).sum(-1)
    return K2_TIE_ULPS * 2.0 ** -23 * scale


def k2_exactness(f_b, f_a, idx, chunk=4096):
    """Picks `idx` against the exact nearest rows, in float64: (rows whose
    pick's exact distance exceeds the least one by more than `K2_TIE_RTOL`
    relative, rows where it also exceeds `k2_resolution`)."""
    fa = f_a.double()
    a_sq = (fa * fa).sum(-1)
    beyond_rtol = beyond_rule = 0
    for c in range(0, f_b.shape[0], chunk):
        fb = f_b[c:c + chunk].double()
        pick = idx[c:c + chunk]
        least = ((fb * fb).sum(-1)[:, None] + a_sq[None, :]
                 - 2.0 * fb @ fa.T).min(-1).values.clamp_min(0.0)
        diff = fb - fa.index_select(0, pick)
        excess = (diff * diff).sum(-1) - least
        over = excess > K2_TIE_RTOL * least
        beyond_rtol += int(over.sum())
        beyond_rule += int((over & (
            excess > K2_TIE_RTOL * least
            + k2_resolution(f_b[c:c + chunk], f_a, pick))).sum())
    return beyond_rtol, beyond_rule


# When the running phase started (main sets it): every phase line gets
# its `seconds` since then.
PHASE_T0 = [time.perf_counter()]


def emit(obj) -> None:
    """One JSON line on stdout, and appended to chiprun_out/chip_smoke.jsonl
    beside this script (the whole record, where stdout may be cut)."""
    import os

    if "phase" in obj and "seconds" not in obj:
        obj = {**obj, "seconds": time.perf_counter() - PHASE_T0[0]}
    line = json.dumps(obj)
    print(line, flush=True)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


# Cycles of `torch.cuda._sleep` queued ahead of a start event: about a
# millisecond at the H100's clocks, longer than a wrapper's host time
# before its launch, so the start event lands while the queue is busy
# and the reading spans the device work alone.
BUSY_CYCLES = 2_000_000


def busy_queue() -> None:
    torch.cuda._sleep(BUSY_CYCLES)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median milliseconds of `fn` over `reps` runs, by CUDA events, each
    start event recorded behind `busy_queue` (a start event on an idle
    queue would add the wrapper's host time before the launch)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        busy_queue()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> float:
    return 1e3 * max(flops / peak_flops, nbytes / PEAK_BYTES)


@contextlib.contextmanager
def Modes(cand_dtype, prune, polish):
    """Sets the port's compressed-candidate and polish modes inside a
    `with`, and restores the ones it found in a `finally` (a failure
    inside still propagates)."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.models import patchmatch as pm

    saved = (pt._CAND_DTYPE, pt._CAND_PRUNE, pm._POLISH_MODE)
    try:
        pt.set_cand_compression(cand_dtype, prune)
        pm.set_polish_mode(polish)
        yield
    finally:
        pt._CAND_DTYPE, pt._CAND_PRUNE, pm._POLISH_MODE = saved


def k1_case(dev, rng, size=1024):
    """K1's inputs at the headline's level-0 shapes: 1024^2 B and A, 4
    channels with the coarse pair, seeded candidate tables with invalid
    slots, an incoming state; returns (A images, args, kw)."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    cfg = SynthConfig()
    h = w = ha = wa = size
    specs = pt.channel_specs(1, 1, cfg, True)
    geom = pt.tile_geometry(h, w, specs)

    def img(shape):
        return torch.as_tensor(rng.random(shape, dtype=np.float32), device=dev)

    src_a, flt_a, src_b, flt_b = (img((ha, wa)), img((ha, wa)),
                                  img((h, w)), img((h, w)))
    src_ac, flt_ac, src_bc, flt_bc = (img((ha // 2, wa // 2)),
                                      img((ha // 2, wa // 2)),
                                      img((h // 2, w // 2)),
                                      img((h // 2, w // 2)))
    a_planes = pt.prepare_a_planes(src_a, flt_a, src_ac, flt_ac, specs)
    b_planes = pt.prepare_b_planes(src_b, flt_b, src_bc, flt_bc, geom)
    qy = torch.arange(h, device=dev)[:, None].expand(h, w)
    qx = torch.arange(w, device=dev)[None, :].expand(h, w)
    oy0 = torch.as_tensor(rng.integers(0, ha, (h, w)), device=dev) - qy
    ox0 = torch.as_tensor(rng.integers(0, wa, (h, w)), device=dev) - qx
    oy = pt.to_compact(oy0.to(torch.int32), geom)
    ox = pt.to_compact(ox0.to(torch.int32), geom)
    # Incoming distances: +inf on half the pixels (a first sweep), the
    # rest spread across the candidates' own range (~0.3-1.0 for random
    # planes), so both minima and the kappa merge all take part.
    d_np = 0.3 + 0.7 * rng.random(oy.shape, dtype=np.float32)
    d_np[rng.random(oy.shape) < 0.5] = np.inf
    d_in = torch.as_tensor(d_np, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cand_y, cand_x, valid = pt.sample_candidates_blocked(
        oy, ox, pt.draw_candidates(gen, geom, ha, wa), geom, ha, wa
    )
    drop = torch.as_tensor(rng.random(valid.shape) < 0.3, device=dev)
    valid = torch.where(drop, torch.zeros_like(valid), valid).contiguous()
    args = (a_planes, b_planes, cand_y, cand_x, valid, oy, ox, d_in)
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.5)
    return (src_a, flt_a, src_ac, flt_ac), args, kw


def k1_flops_bytes(args, kw, a_itemsize):
    """K1's compulsory work for one launch on these inputs: FLOP of the
    valid slots (3 per channel difference, 4 per tap, the group adds, and
    2 per loaded value to dequantize int8) and the bytes of the planes
    once, the tables, and the state in and out; with a frame axis, every
    frame's B planes, tables and state, and the shared A planes once."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    a_planes, b_planes, valid = args[0], args[1], args[4]
    specs, geom = kw["specs"], kw["geom"]
    n_frames = b_planes.shape[0] if b_planes.ndim == 4 else 1
    n_valid = int(valid.sum())
    groups = pt.spec_groups(specs)
    flop_per_px = 3 * len(specs) + sum(
        4 * len(sp.wy) for sp, _ in groups
    ) + len(groups) + (2 * len(specs) if a_itemsize == 1 else 0)
    flops = n_valid * geom.tile_h * geom.tile_w * flop_per_px
    state = n_frames * geom.n_ty * geom.tile_h * geom.n_tx * geom.tile_w * 4
    nbytes = a_planes.numel() * a_itemsize + b_planes.numel() * 4 \
        + 3 * valid.numel() * 4 + 6 * state
    return n_valid, flops, nbytes


def capture_real_case(dev):
    """K1's inputs as the headline gives them: the planes, candidate
    tables and incoming state of the first level-0 (1024^2) sweep of one
    headline run, taken at the call of `tile_sweep`; (A planes, args, kw)
    like `k1_case`, the A images replaced by the float32 A planes."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.utils.examples import super_resolution

    seen = []
    real = pt.tile_sweep

    def spy(*args, **kw):
        if not seen and kw["ha"] == 1024 and kw["geom"].n_ty == 16:
            seen.append((tuple(t.clone() for t in args), dict(kw)))
        return real(*args, **kw)

    pt.tile_sweep = spy
    try:
        run_synth(super_resolution(1024), SynthConfig(**HEADLINE))
    finally:
        pt.tile_sweep = real
    if not seen:
        raise AssertionError("the headline ran no level-0 tile sweep")
    args, kw = seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    return args[0], one_frame(args), kw


def one_frame(args):
    """A sweep's arguments as the tile path passes them for one image (a
    frame axis of 1 on the B side), without the axis."""
    if args[1].ndim != 4 or args[1].shape[0] != 1:
        raise AssertionError(f"B planes {tuple(args[1].shape)}: not one "
                             "frame")
    return args[:1] + tuple(t[0] for t in args[1:])


def quantize_planes(a_planes):
    """float32 A planes on the int8 grid of `prepare_a_planes` (edge
    padding and pointwise quantization commute)."""
    return torch.clamp(torch.round(a_planes * 254.0 - 127.0), -127.0,
                       127.0).to(torch.int8)


def k1_check(args, kw, what, hw=(1024, 1024)):
    """One K1 launch against the plain version on the same inputs, a
    level of `hw` = (h, w): distances within rtol 1e-4 / atol 1e-5,
    offsets equal except at ties (`unexplained_offsets`).  Returns
    (kernel result, stats)."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    a_planes, b_planes, _, _, valid, oy, ox, d_in = args
    h, w = hw
    geo = {k: v for k, v in kw.items() if k != "coh_factor"}
    got = pt.tile_sweep_kernel(*args, **kw)
    want = pt.tile_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    kd, pd = got[2][:h, :w], want[2][:h, :w]
    if not bool(torch.isfinite(pd).all()):
        raise AssertionError(f"{what}: plain version left a pixel at +inf")
    close = (kd - pd).abs() <= 1e-5 + 1e-4 * pd.abs()
    if not bool(close.all()):
        raise AssertionError(
            f"{what}: distances disagree at {int((~close).sum())} pixels")
    off_diff = (got[0][:h, :w] != want[0][:h, :w]) | (
        got[1][:h, :w] != want[1][:h, :w])
    bad = pt.unexplained_offsets(got, want, (oy, ox, d_in), a_planes,
                                 b_planes, h=h, w=w, **geo)
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: offsets differ off ties at {int(bad.sum())} pixels")
    # The other route inside the kernel on the same inputs: the general
    # instantiation (run-time tap loops).
    alt = pt.tile_sweep_kernel(*args, general=True, **kw)
    torch.cuda.synchronize()
    ad = alt[2][:h, :w]
    if not bool(((ad - pd).abs() <= 1e-5 + 1e-4 * pd.abs()).all()):
        raise AssertionError(f"{what}: general instantiation disagrees")
    bad_alt = pt.unexplained_offsets(alt, want, (oy, ox, d_in), a_planes,
                                     b_planes, h=h, w=w, **geo)
    if bool(bad_alt.any()):
        raise AssertionError(f"{what}: general instantiation's offsets "
                             f"differ off ties at {int(bad_alt.sum())} "
                             "pixels")
    return got, {
        "max_abs_err": float((kd - pd).abs().max()),
        "changed_frac": float((pd != d_in[:h, :w]).float().mean()),
        "offset_mismatch_frac": float(off_diff.float().mean()),
        "unexplained_offsets": int(bad.sum()),
        "valid_slots": int((valid > 0).sum()),
    }


def k1_timing(args, kw, l2_rate):
    """Kernel and plain milliseconds, the HBM/FLOP bound and the L2
    floor of one K1 launch on these inputs."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    itemsize = args[0].element_size()
    _, flops, nbytes = k1_flops_bytes(args, kw, itemsize)
    rows = pt.sweep_plan(len(kw["specs"]), kw["geom"].halo)
    win = pt.window_bytes(args[4], kw["specs"], kw["geom"], itemsize)
    return {
        "ms": cuda_ms(lambda: pt.tile_sweep_kernel(*args, **kw)),
        "general_ms": cuda_ms(
            lambda: pt.tile_sweep_kernel(*args, general=True, **kw)),
        "plain_ms": cuda_ms(lambda: pt.tile_sweep_plain(*args, **kw),
                            reps=10, warm=1),
        "bound_ms": bound_ms(flops, nbytes),
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        "flops": flops, "bytes": nbytes, "strip_rows": rows,
        "window_bytes": win,
        "l2_floor_ms": 1e3 * win / l2_rate,
    }


def phase_k1(dev, case, real, l2_rate):
    """K1 against its plain version at the headline's level-0 shapes,
    kappa > 1: the seeded case (`k1_case`) and the headline's own first
    level-0 sweep (`capture_real_case`), whose offsets cluster."""
    _, args, kw = case
    _, stats = k1_check(args, kw, "K1")
    rec = {"phase": "k1", "shape": [1024, 1024, kw["ha"], kw["wa"]],
           "channels": len(kw["specs"]), "slots": int(args[4].numel()),
           "tol": "rtol 1e-4 / atol 1e-5; offsets equal off ties",
           "l2_read_bytes_per_s": l2_rate}
    rec.update(stats)
    rec.update(k1_timing(args, kw, l2_rate))
    _, r_args, r_kw = real
    _, r_stats = k1_check(r_args, r_kw, "K1 real-run")
    rec["real_run"] = {**r_stats, **k1_timing(r_args, r_kw, l2_rate)}
    emit(rec)
    return rec


def phase_k1i8(dev, case, real, l2_rate):
    """K1 in int8 mode at the same shapes, seeded and real-run: against
    its plain version (distances within rtol 1e-4 / atol 1e-5, offsets
    equal off ties), and against the float32 kernel on host-dequantized
    planes (offsets equal on every pixel, distances within rtol 1e-5)."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    h = w = 1024

    def one(a8, args, kw, what):
        args8 = (a8,) + tuple(args[1:])
        got, stats = k1_check(args8, kw, what)
        deq = pt.tile_sweep_kernel(pt.dequantize_planes(a8), *args[1:], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], deq[0]) and torch.equal(got[1], deq[1])):
            raise AssertionError(f"{what}: offsets differ from the f32 "
                                 "kernel on dequantized planes")
        kd, dd = got[2][:h, :w], deq[2][:h, :w]
        if not bool(((kd - dd).abs() <= 1e-5 * dd.abs()).all()):
            raise AssertionError(f"{what}: distances differ from the f32 "
                                 "kernel on dequantized planes beyond rtol "
                                 "1e-5")
        stats["max_abs_err_vs_f32_dequant"] = float((kd - dd).abs().max())
        return {**stats, **k1_timing(args8, kw, l2_rate)}

    imgs, args, kw = case
    rec = {"phase": "k1i8",
           "tol": "rtol 1e-4 / atol 1e-5 vs plain, offsets equal off ties; "
                  "offsets equal and rtol 1e-5 vs f32 on dequantized planes"}
    rec.update(one(pt.prepare_a_planes(*imgs, kw["specs"],
                                       cand_dtype="int8"),
                   args, kw, "K1 int8"))
    r_planes, r_args, r_kw = real
    rec["real_run"] = one(quantize_planes(r_planes), r_args, r_kw,
                          "K1 int8 real-run")
    emit(rec)
    return rec


def phase_k3(dev, rng):
    """K3 against its plain version at the 1024^2 level 0: a (1024^2, 68)
    bf16 feature table LANE-padded (`prepare_polish_table`), the same
    table quantized (`quantize_rows`), and 1,048,576 indices of a seeded
    field with out-of-range entries for the clamp; bit-equal in both
    dtypes.  The library yardstick is `index_select` on the clamped
    indices."""
    from image_analogies_tpu_torch.kernels import polish_stream as ps

    n, d = 1024 * 1024, 68
    f16 = torch.as_tensor(rng.random((n, d), dtype=np.float32),
                          device=dev).to(torch.bfloat16)
    q, _ = ps.quantize_rows(f16)
    idx = torch.as_tensor(rng.integers(-1000, n + 1000, n), device=dev)
    clamped = idx.clamp(0, n - 1)
    rec = {"phase": "k3", "rows": n, "out_of_range":
           int(((idx < 0) | (idx >= n)).sum())}
    for name, table in (("bf16", ps.prepare_polish_table(f16)),
                        ("int8", ps.prepare_polish_table(q))):
        got = ps.gather_rows_kernel(table, idx)
        want = ps.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 rows differ from index_select ({name})")
        # Each LANE-wide row read once and written once, and the indices.
        row_bytes, _ = ps.polish_dma_bytes_per_fetch(
            ps.LANE, table.element_size())
        nbytes = n * (2 * row_bytes + idx.element_size())
        rec[name] = {
            "row_bytes": row_bytes,
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: ps.gather_rows_kernel(table, idx)),
            "plain_ms": cuda_ms(lambda: ps.gather_rows_plain(table, idx)),
            "library_ms": cuda_ms(lambda: table.index_select(0, clamped)),
            "bound_ms": bound_ms(0.0, nbytes), "bound_by": "bytes",
            "bytes": nbytes,
        }
    emit(rec)
    return rec


def k4_case(dev, rng, h, d, dtype, n_random, l2_rate):
    """K4 on one sweep of an h x h field against an h x h A, (h^2, d)
    tables in `dtype`: bit-equal to its plain version on integer-valued
    tables (every sum exact, ties everywhere), then timed on uniform
    ones beside its bounds."""
    from image_analogies_tpu_torch.kernels import pixel_cascade as pc
    from image_analogies_tpu_torch.models.matcher import candidate_dist_lean
    from image_analogies_tpu_torch.models.patchmatch import sweep_radii

    n = h * h
    py = torch.as_tensor(rng.integers(0, h, (h, h)), device=dev)
    px = torch.as_tensor(rng.integers(0, h, (h, h)), device=dev)
    off = torch.stack([
        torch.as_tensor(rng.integers(-r, r + 1, (h, h, 2)), device=dev)
        for r in sweep_radii(h, h, n_random)])
    kw = dict(ha=h, wa=h, coh_factor=1.5)
    rec = {"shape": [h, h, d], "dtype": str(dtype).split(".")[-1],
           "n_random": n_random}
    for integer in (True, False):
        f_b, f_a = (torch.as_tensor(
            (rng.integers(0, 5, (n, d)) if integer else rng.random((n, d)))
            .astype(np.float32), device=dev).to(dtype) for _ in range(2))

        def dist_fn(idx):
            return candidate_dist_lean(f_b, f_a, idx)

        dist = dist_fn((py * h + px).reshape(-1)).reshape(h, h)
        got = pc.cascade_sweep_kernel(f_b, f_a, py, px, dist, off, **kw)
        want = pc.cascade_sweep_plain(py, px, dist, off, dist_fn=dist_fn,
                                      **kw)
        torch.cuda.synchronize()
        if integer:
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"K4 {h}^2 {dtype} differs from its "
                                     "plain version on integer tables")
            continue
        rec["match_share_vs_plain"] = float(
            ((got[0] == want[0]) & (got[1] == want[1])).float().mean())
        rec["max_abs_err"] = float((got[2] - want[2]).abs().max())
        rec["max_rel_err"] = float(
            ((got[2] - want[2]).abs() / want[2].clamp_min(1e-30)).max())
        rec["ms"] = cuda_ms(lambda: pc.cascade_sweep_kernel(
            f_b, f_a, py, px, dist, off, **kw))
        rec["plain_ms"] = cuda_ms(lambda: pc.cascade_sweep_plain(
            py, px, dist, off, dist_fn=dist_fn, **kw), reps=3, warm=1)
    row = d * f_b.element_size()
    # Compulsory bytes: both tables, the field in and out (int64 py,
    # px and float32 dist) and the offsets, each once.
    nbytes = 2 * n * row + n * 2 * 20 + off.numel() * 8
    # Row traffic: every candidate reads its A row and the pixel's B row.
    row_bytes = n * (8 + n_random) * 2 * row
    rec.update({
        "bound_ms": bound_ms(0.0, nbytes), "bound_by": "bytes",
        "bytes": nbytes, "row_bytes": row_bytes,
        "rows_hbm_floor_ms": 1e3 * row_bytes / PEAK_BYTES,
        "rows_l2_floor_ms": 1e3 * row_bytes / l2_rate if l2_rate else None,
    })
    return rec


def phase_k4(dev, rng, l2_rate=None):
    """K4 at the two shapes the main path gives it: the 64^2 per-pixel
    level (float32 rows of 50, 6 random probes) and the 1024^2 polish
    (bf16 rows of 68, 4 probes); one sweep a launch."""
    rec = {"phase": "k4",
           "pixel": k4_case(dev, rng, 64, 50, torch.float32, 6, l2_rate),
           "polish": k4_case(dev, rng, 1024, 68, torch.bfloat16, 4,
                             l2_rate)}
    emit(rec)
    return rec


def k2_case(dev, rng, n_b, n_a, d, library_chunk=8192):
    """K2 against its plain version on seeded (n_b, d) / (n_a, d) tables,
    float32 rows (three TF32 passes; the plain version repeats them) and
    bfloat16 rows, with times, bounds and the library yardstick."""
    from image_analogies_tpu_torch.kernels import nn_brute as nb
    from image_analogies_tpu_torch.models.matcher import candidate_dist

    f_b = torch.as_tensor(rng.random((n_b, d), dtype=np.float32), device=dev)
    f_a = torch.as_tensor(rng.random((n_a, d), dtype=np.float32), device=dev)
    a_sq = nb.squared_norms(f_a)
    idx_k = nb.nn_argmin_kernel(f_b, f_a, a_sq)
    idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq, tf32_passes=3)
    idx_f = nb.nn_argmin_plain(f_b, f_a, a_sq)
    torch.cuda.synchronize()
    d_k = candidate_dist(f_b, f_a, idx_k)
    d_p = candidate_dist(f_b, f_a, idx_p)
    d_f = candidate_dist(f_b, f_a, idx_f)
    differ = idx_k != idx_p
    for ref, d_ref, name in ((idx_p, d_p, "its plain version"),
                             (idx_f, d_f, "the float32 argmin")):
        off = (idx_k != ref) & ((d_k - d_ref).abs() > 1e-5 * d_ref.abs())
        if bool(off.any()):
            raise AssertionError(
                f"K2 {n_b}x{n_a}x{d}: argmin differs from {name} off ties "
                f"at {int(off.sum())} rows")

    def library():
        out = []
        for c in range(0, n_b, library_chunk):
            out.append(torch.argmin(
                a_sq[None, :] - 2.0 * torch.matmul(
                    f_b[c:c + library_chunk], f_a.T), dim=-1))
        return torch.cat(out)

    ms = cuda_ms(lambda: nb.nn_argmin_kernel(f_b, f_a, a_sq))
    flops = 2.0 * n_b * n_a * d
    # Three TF32 products per pair at the padded width.
    flops_tf32 = 3 * 2.0 * n_b * n_a * nb.padded_dim(d, torch.float32)
    nbytes = (n_b + n_a) * d * 4 + n_a * 4 + n_b * 4
    bound = bound_ms(flops_tf32, nbytes, PEAK_TF32_FLOPS)

    # bfloat16 rows (match_dtype="bfloat16"): the same argmin on rounded
    # rows with float32 products; ties judged in that metric.
    bf = torch.bfloat16
    fb16, fa16 = f_b.to(bf), f_a.to(bf)
    i16_k = nb.nn_argmin_kernel(fb16, fa16, a_sq)
    i16_p = nb.nn_argmin_plain(f_b, f_a, a_sq, match_dtype=bf)
    torch.cuda.synchronize()
    m_k = nb.argmin_metric(f_b, f_a, a_sq, i16_k, bf)
    m_p = nb.argmin_metric(f_b, f_a, a_sq, i16_p, bf)
    differ16 = i16_k != i16_p
    if bool((differ16 & ((m_k - m_p).abs() > 1e-5 * m_p.abs())).any()):
        raise AssertionError(f"K2 bf16 {n_b}x{n_a}x{d}: argmin differs off "
                             "ties")
    ms16 = cuda_ms(lambda: nb.nn_argmin_kernel(fb16, fa16, a_sq))
    bytes16 = (n_b + n_a) * d * 2 + n_a * 4 + n_b * 4
    bound16 = bound_ms(flops, bytes16, PEAK_BF16_FLOPS)
    if bound > ms or bound16 > ms16:
        raise AssertionError("K2 ran faster than its bound: the bound is "
                             "wrong")
    return {
        "shape": [n_b, n_a, d], "rows_differ": int(differ.sum()),
        "rows_differ_from_f32_argmin": int((idx_k != idx_f).sum()),
        "max_abs_err": float((d_k - d_p).abs().max()),
        "tie": "exact f32 distances within 1e-5 rel",
        "ms": ms,
        "plain_ms": cuda_ms(lambda: nb.nn_argmin_plain(
            f_b, f_a, a_sq, tf32_passes=3)),
        "library_ms": cuda_ms(library),
        "bound_ms": bound, "bound_by": "operations",
        "bound": "3 x 2 N_B N_A D_pad FLOP at 495 TFLOP/s of TF32",
        "share_of_bound_rate": bound / ms,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "achieved_tf32_tflops": flops_tf32 / (ms * 1e-3) / 1e12,
        "peak_tf32_tflops": PEAK_TF32_FLOPS / 1e12,
        "bf16": {
            "rows_differ": int(differ16.sum()),
            "max_abs_err": float((m_k - m_p).abs().max()),
            "tie": "the kernel's own metric (f64) within 1e-5 rel",
            "ms": ms16,
            "plain_ms": cuda_ms(lambda: nb.nn_argmin_plain(
                f_b, f_a, a_sq, match_dtype=bf)),
            "bound_ms": bound16, "bound_by": "operations",
            "share_of_bound_rate": bound16 / ms16,
            "achieved_tflops": flops / (ms16 * 1e-3) / 1e12,
            "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
        },
    }


def phase_k2(dev, rng):
    """K2 at 65,536 x 65,536 x 68 (the 256^2 level 0) and at a ragged
    10,007 x 9,001 x 150 (rgb feature width, no size a multiple of the
    tile)."""
    rec = {"phase": "k2"}
    rec.update(k2_case(dev, rng, 65536, 65536, 68))
    rec["ragged"] = k2_case(dev, rng, 10007, 9001, 150)
    emit(rec)
    return rec


def run_synth(example, cfg):
    from image_analogies_tpu_torch import create_image_analogy

    a, ap, b = example
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = create_image_analogy(a, ap, b, cfg)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_output(out, shape, what):
    if tuple(out.shape) != tuple(shape):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    lo, hi, std = float(out.min()), float(out.max()), float(out.std())
    if lo < 0.0 or hi > 1.0 or std <= 0.05:
        raise AssertionError(f"{what}: min {lo} max {hi} std {std}")
    return std


def phase_headline(dev):
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import (
        nn_brute,
        patchmatch_tile,
        pixel_cascade,
    )
    from image_analogies_tpu_torch.utils.examples import super_resolution

    ex = super_resolution(1024)
    cfg = SynthConfig(**HEADLINE)
    run_synth(ex, cfg)  # warm
    # K4: every sweep of the per-pixel level (64^2: em_iters x pm_iters)
    # and of the tile levels' final-step polish, 12 + 4 x 1 = 16.
    tile_levels = sum(1 for lv in range(cfg.levels) if (1024 >> lv) >= 128)
    k4_want = ((cfg.levels - tile_levels) * cfg.em_iters * cfg.pm_iters
               + tile_levels * cfg.pm_polish_iters)
    walls, counts, k4_counts = [], [], []
    out = None
    for _ in range(3):
        patchmatch_tile.launches.reset()
        nn_brute.launches.reset()
        pixel_cascade.launches.reset()
        out, wall = run_synth(ex, cfg)
        counts.append(patchmatch_tile.launches.count)
        k4_counts.append(pixel_cascade.launches.count)
        walls.append(wall)
        if patchmatch_tile.launches.count != 48:
            raise AssertionError(
                f"K1 launched {patchmatch_tile.launches.count} times, not 48"
            )
        if pixel_cascade.launches.count != k4_want:
            raise AssertionError(
                f"K4 launched {pixel_cascade.launches.count} times, not "
                f"{k4_want}")
    std = check_output(out, ex[2].shape, "headline")
    rec = {"phase": "headline", "size": 1024, "levels": 5,
           "wall_s_median": statistics.median(walls), "walls_s": walls,
           "k1_launches_per_run": counts, "k4_launches_per_run": k4_counts,
           "bp_std": std}
    emit(rec)
    return rec, counts[-1]


def phase_compressed(dev, size=1024, quality_size=512):
    """The headline with compressed candidates (int8 A planes and polish
    rows, PCA prune 16:8): the streamed polish (K3) and the sequential
    one, in turns with the default path, median of 3 warm walls each;
    launch counts per run; stream B' bit-equal to sequential B'; then at
    512^2 the compressed + stream and the jump polish against the brute
    oracle."""
    from image_analogies_tpu_torch import psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.kernels import polish_stream as ps
    from image_analogies_tpu_torch.utils.examples import super_resolution

    ex = super_resolution(size)
    cfg = SynthConfig(**HEADLINE)
    # Launches per run.  Tile levels: the sides 1024, 512, 256 and 128
    # (64^2 is below the tile rule and runs the per-pixel path).  K1:
    # pm_iters sweeps per EM step, em_iters steps per tile level,
    # 4 x 2 x 6 = 48.  K3: the polish gathers once per candidate
    # evaluation, 1 + iters * (8 + n_random) times per polished call
    # (`polish_eval_rows` per query row: the entry evaluation, then per
    # sweep 4 shifted + 4 unshifted propagation candidates and 4 random
    # probes), one polished EM step per tile level (pm_polish_final_only:
    # the last of em_iters = 2), 4 x 1 x (1 + 1 x (8 + 4)) = 52.
    tile_levels = sum(1 for lv in range(cfg.levels) if (size >> lv) >= 128)
    k1_per_run = tile_levels * cfg.em_iters * cfg.pm_iters
    k3_per_run = tile_levels * ps.polish_eval_rows(
        1, cfg.pm_polish_iters, cfg.pm_polish_random)
    arms = {
        "default": ("bf16", "off", "sequential"),
        "compressed_stream": ("int8", "16:8", "stream"),
        "compressed_sequential": ("int8", "16:8", "sequential"),
    }
    walls = {name: [] for name in arms}
    outs, launches = {}, {}
    counters = (pt.launches, pt.launches_int8, ps.launches)
    for rep in range(4):  # the first round warms each arm
        for name, modes in arms.items():
            with Modes(*modes):
                for c in counters:
                    c.reset()
                out, wall = run_synth(ex, cfg)
            counts = tuple(c.count for c in counters)
            compressed = modes[0] == "int8"
            want = (0, k1_per_run, k3_per_run if modes[2] == "stream"
                    else 0) if compressed else (k1_per_run, 0, 0)
            launches[name] = counts
            if counts != want:
                raise AssertionError(
                    f"{name}: launches (K1 f32, K1 int8, K3) {counts}, "
                    f"not {want}")
            if rep:
                walls[name].append(wall)
            outs[name] = out
    std = check_output(outs["compressed_stream"], ex[2].shape, "compressed")
    if not torch.equal(outs["compressed_stream"],
                       outs["compressed_sequential"]):
        raise AssertionError("stream B' differs from sequential B'")
    rec = {
        "phase": "compressed", "size": size, "levels": cfg.levels,
        "k1_int8_launches_per_run": launches["compressed_stream"][1],
        "k3_launches_per_run": launches["compressed_stream"][2],
        "k3_launches_derived": k3_per_run,
        "stream_equals_sequential": True, "bp_std": std,
        "psnr_compressed_vs_default": psnr(outs["compressed_stream"],
                                                outs["default"]),
    }
    for name in arms:
        rec[f"wall_s_median_{name}"] = statistics.median(walls[name])
        rec[f"walls_s_{name}"] = walls[name]

    ex5 = super_resolution(quality_size)
    kw = dict(levels=5, em_iters=2, device="cuda")
    oracle, _ = run_synth(ex5, SynthConfig(matcher="brute", **kw))
    for name, modes in (("compressed_stream", arms["compressed_stream"]),
                        ("jump", ("bf16", "off", "jump"))):
        with Modes(*modes):
            bp, wall = run_synth(ex5, SynthConfig(matcher="patchmatch", **kw))
        value = psnr(bp, oracle)
        rec[f"psnr_{quality_size}_{name}"] = value
        rec[f"wall_{quality_size}_{name}_s"] = wall
        if not value >= 33.0:
            raise AssertionError(f"{name} PSNR vs oracle at "
                                 f"{quality_size}^2 {value} < 33 dB")
    rec["psnr_compressed_stream_meets_35"] = bool(
        rec[f"psnr_{quality_size}_compressed_stream"] >= 35.0)
    emit(rec)
    return rec


def phase_profile(dev):
    """One headline run under torch.profiler, default and compressed:
    device time by kernel, and the device's idle share of the wall."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.utils.examples import super_resolution

    ex = super_resolution(1024)
    cfg = SynthConfig(**HEADLINE)
    recs = [profile_call(lambda: run_synth(ex, cfg), "default")]
    with Modes("int8", "16:8", "stream"):
        recs.append(profile_call(lambda: run_synth(ex, cfg),
                                 "compressed_stream"))
    return recs


def profile_call(fn, arm):
    """One call of `fn` (after a warm one) under torch.profiler: device
    time by kernel, the device's idle share of the wall, and the host
    ops with the most self CPU time.  A session late in a long process
    can drop device events, so the trace must hold every K1 launch the
    launch counters booked during the call, or this raises."""
    from torch.profiler import ProfilerActivity, profile

    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    t_call = time.perf_counter()
    fn()  # warm
    booked0 = pt.launches.count + pt.launches_int8.count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    booked = pt.launches.count + pt.launches_int8.count - booked0
    rows, host = [], []
    for ev in prof.key_averages():
        # Device-side events (kernels, memcpy, memset) apart: the CPU ops
        # that launched them carry the same device time again.  The
        # `tlm_*` ranges also appear on the device side, spanning their
        # kernels: they are not device work of their own.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((ev.self_cpu_time_total, ev.key, ev.count))
            continue
        if ev.key.startswith("tlm_"):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    traced = sum(n for _, k, n in rows if "tile_sweep_kernel" in k)
    if traced != booked:
        raise AssertionError(
            f"profile {arm}: the trace holds {traced} K1 launches, the "
            f"launch counters booked {booked}")
    busy_ms = sum(t for t, _, _ in rows) / 1e3
    rec = {
        "phase": "profile", "arm": arm, "wall_s": wall,
        "k1_launches_traced": traced, "k1_launches_booked": booked,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "device_events": sum(n for _, _, n in rows),
        "top": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                for t, k, n in rows[:12]],
        "host_top": [{"name": k[:90], "self_cpu_ms": t / 1e3, "calls": n}
                     for t, k, n in host[:8]],
        # The whole call: the warm run, the traced one, the trace's
        # processing.
        "call_s": time.perf_counter() - t_call,
    }
    emit(rec)
    return rec


def phase_config1(dev):
    """Texture-by-numbers at 256^2 with the brute oracle, float32 and
    bfloat16: 6 K2 launches each.  On the float32 run's own level-0
    tables the kernel's picks are held against the plain version's
    (`tf32_passes=3`): every differing entry must be a tie; and the same
    run with the plain version in K2's place gives a second B' whose PSNR
    against the kernel's is reported (texture-by-numbers is full of
    near-ties, and a tie taken the other way early in the EM moves later
    pixels).  The same picks, the plain version's and the float32
    matmul argmin's are also held against the exact nearest rows in
    float64 (`k2_exactness`): how many of each lie beyond 1e-5 relative
    of the least distance shows what the float32 expansion itself costs,
    whatever computes it."""
    from image_analogies_tpu_torch import psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import nn_brute, patchmatch_tile
    from image_analogies_tpu_torch.models import brute
    from image_analogies_tpu_torch.models.matcher import candidate_dist
    from image_analogies_tpu_torch.utils.examples import texture_by_numbers

    ex = texture_by_numbers(256)
    cfg = SynthConfig(levels=3, matcher="brute", em_iters=2, device="cuda")
    run_synth(ex, cfg)  # warm
    patchmatch_tile.launches.reset()
    nn_brute.launches.reset()
    out, wall = run_synth(ex, cfg)
    count = nn_brute.launches.count
    if count != 6:
        raise AssertionError(f"K2 launched {count} times, not 6")
    std = check_output(out, ex[2].shape, "config1")

    # Level-0 picks, kernel against plain, on the run's own tables.
    seen = []
    real = brute.nn_argmin

    def spy(f_b, f_a, *args, **kw):
        idx = real(f_b, f_a, *args, **kw)
        if f_b.shape[0] == 256 * 256:
            seen.append((f_b, f_a, idx))
        return idx

    def plain_k2(f_b, f_a, chunk=4096, match_dtype=torch.float32):
        return nn_brute.nn_argmin_plain(
            f_b, f_a, nn_brute.squared_norms(f_a), chunk, match_dtype,
            tf32_passes=3)

    brute.nn_argmin = spy
    try:
        run_synth(ex, cfg)
        brute.nn_argmin = plain_k2
        out_plain, _ = run_synth(ex, cfg)
    finally:
        brute.nn_argmin = real
    differ_total = beyond_rtol = 0
    vs_exact = {"kernel": [0, 0], "plain_split": [0, 0],
                "plain_f32_matmul": [0, 0]}
    for f_b, f_a, idx_k in seen:
        idx_p = plain_k2(f_b, f_a)
        idx_f = nn_brute.nn_argmin_plain(f_b, f_a,
                                         nn_brute.squared_norms(f_a))
        for name, idx in (("kernel", idx_k), ("plain_split", idx_p),
                          ("plain_f32_matmul", idx_f)):
            for i, n in enumerate(k2_exactness(f_b, f_a, idx)):
                vs_exact[name][i] += n
        d_k = candidate_dist(f_b, f_a, idx_k)
        d_p = candidate_dist(f_b, f_a, idx_p)
        differ = idx_k != idx_p
        gap = (d_k - d_p).abs()
        beyond_rtol += int((differ & (gap > K2_TIE_RTOL * d_p.abs())).sum())
        off = differ & (gap > K2_TIE_RTOL * d_p.abs()
                        + k2_resolution(f_b, f_a, idx_p))
        if bool(off.any()):
            raise AssertionError(
                f"config1: K2 differs from its plain version off ties at "
                f"{int(off.sum())} level-0 entries")
        differ_total += int(differ.sum())
    if vs_exact["kernel"][1]:
        raise AssertionError(
            f"config1: {vs_exact['kernel'][1]} of K2's level-0 picks lie "
            "beyond the tie rule from the exact nearest row")

    cfg16 = SynthConfig(levels=3, matcher="brute", em_iters=2,
                        match_dtype="bfloat16", device="cuda")
    run_synth(ex, cfg16)  # warm
    nn_brute.launches.reset()
    out16, wall16 = run_synth(ex, cfg16)
    if nn_brute.launches.count != 6:
        raise AssertionError(
            f"K2 (bf16) launched {nn_brute.launches.count} times, not 6")
    check_output(out16, ex[2].shape, "config1 bf16")
    rec = {"phase": "config1", "size": 256, "wall_s": wall,
           "k2_launches": count, "bp_std": std, "wall_bf16_s": wall16,
           "k2_launches_bf16": nn_brute.launches.count,
           "psnr_bf16_vs_f32": psnr(out16, out),
           "level0_calls": len(seen),
           "level0_entries_differ_from_plain": differ_total,
           "level0_entries_beyond_rtol_alone": beyond_rtol,
           "tie": f"exact f32 distances within {K2_TIE_RTOL} rel or "
                  f"{K2_TIE_ULPS} float32 ulps of ||a||^2 + ||b||^2",
           "level0_picks_vs_exact_f64_argmin": {
               name: {"beyond_rtol": v[0], "beyond_tie_rule": v[1]}
               for name, v in vs_exact.items()},
           "psnr_kernel_vs_plain_k2": psnr(out, out_plain)}
    emit(rec)
    return rec, count


def phase_quality(dev, k2_tflops):
    from image_analogies_tpu_torch import psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.utils.examples import super_resolution

    rec = {"phase": "quality"}
    sizes = [512]
    # The 1024^2 oracle's level-0 search is 2 EM x 2 x 1024^4 x 68 FLOP.
    est_1024 = 2 * 2 * 1024.0**4 * 68 / (k2_tflops * 1e12) * 1.1
    if est_1024 < 60.0:
        sizes.append(1024)
    rec["oracle_1024_est_s"] = est_1024
    for size in sizes:
        ex = super_resolution(size)
        kw = dict(levels=5, em_iters=2, device="cuda")
        if size == 1024:
            kw.update(pm_iters=6, pm_polish_iters=1)
        bp_pm, wall_pm = run_synth(ex, SynthConfig(matcher="patchmatch", **kw))
        bp_bf, wall_bf = run_synth(ex, SynthConfig(matcher="brute", **kw))
        value = psnr(bp_pm, bp_bf)
        rec[f"psnr_{size}"] = value
        rec[f"wall_pm_{size}_s"] = wall_pm
        rec[f"wall_brute_{size}_s"] = wall_bf
        if size == 512 and not value >= 33.0:
            raise AssertionError(f"PSNR vs oracle at 512^2 {value} < 33 dB")
    emit(rec)
    return rec


# The repo's scale configuration (tools/scale_bench.py): super-resolution
# at 2048^2 and 4096^2, 6 levels, other fields at their defaults.
SCALE = dict(levels=6, matcher="patchmatch", em_iters=2, pm_iters=6,
             device="cuda")


def lean_levels(size, levels, budget):
    """Pyramid levels of a square run whose tables pass `budget` by the
    reference's byte rule (`_feature_table_bytes`)."""
    from image_analogies_tpu_torch.models.analogy import _feature_table_bytes

    return [lv for lv in range(levels)
            if _feature_table_bytes(*(4 * (-(-size // 2**lv),))) > budget]


def expected_launches(size, cfg, stream=False):
    """K1 and K3 launches of one PatchMatch run on a square image: K1
    em_iters x pm_iters (size-aware) per tile level (sides >= 128); K3,
    under the stream polish, `polish_eval_rows` per polished EM step of
    each tile level, times the query chunks of `candidate_dist_lean`
    (2^20 rows)."""
    from image_analogies_tpu_torch.kernels import polish_stream as ps
    from image_analogies_tpu_torch.models import patchmatch as pm

    k1 = k3 = 0
    for lv in range(cfg.levels):
        s = -(-size // 2**lv)
        if s < 128:
            continue
        k1 += cfg.em_iters * pm._pm_iters_for(cfg, s, s)
        iters, n_random = pm._polish_schedule_for(cfg, s, s)
        k3 += ps.polish_eval_rows(1, iters, n_random) * -(-s * s // (1 << 20))
    return k1, (k3 if stream else 0)


LAUNCH_NAMES = ("k1", "k1_int8", "k3", "k2")


def lean_counters():
    from image_analogies_tpu_torch.kernels import nn_brute, polish_stream
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    return (pt.launches, pt.launches_int8, polish_stream.launches,
            nn_brute.launches)


def timed_runs(ex, cfg, reps, warm=True):
    """`reps` runs of `create_image_analogy` after an optional warm one:
    (last B', walls, peak GiB allocated above what was held before the
    runs, launches per run by kernel); the launches must agree between
    runs."""
    if warm:
        run_synth(ex, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, counts, out = [], [], None
    for _ in range(reps):
        for c in lean_counters():
            c.reset()
        out, wall = run_synth(ex, cfg)
        walls.append(wall)
        counts.append(tuple(c.count for c in lean_counters()))
    if len(set(counts)) != 1:
        raise AssertionError(f"launches differ between runs: {counts}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return out, walls, peak, dict(zip(LAUNCH_NAMES, counts[0]))


def want_launches(got, what, **want):
    """Raise unless the launches `got` are `want` (unnamed ones: 0)."""
    full = {name: want.get(name, 0) for name in LAUNCH_NAMES}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, not {full}")


@contextlib.contextmanager
def capture_first(module, name, pred):
    """Replace `module.name` inside a `with` by a spy that keeps the
    arguments (cloned) and the result of its first call whose arguments
    satisfy `pred`; yields the list that receives (args, kwargs,
    result)."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        if not seen and pred(*args, **kw):
            seen.append((tuple(t.clone() if isinstance(t, torch.Tensor)
                               else t for t in args), dict(kw), out))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def lean_k1_row(args, kw, hw, what):
    """K1 on a launch the lean path made, captured with its inputs:
    against its plain version (`k1_check`) and, for int8 planes, against
    the float32 kernel on the dequantized planes (offsets equal); kernel
    and plain times and the HBM/FLOP bound of that launch."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    a = args[0]
    got, stats = k1_check(args, kw, what, hw=hw)
    if a.dtype == torch.int8:
        deq = pt.tile_sweep_kernel(pt.dequantize_planes(a), *args[1:], **kw)
        if not (torch.equal(got[0], deq[0]) and torch.equal(got[1], deq[1])):
            raise AssertionError(f"{what}: offsets differ from the f32 "
                                 "kernel on dequantized planes")
    _, flops, nbytes = k1_flops_bytes(args, kw, a.element_size())
    return {
        **stats,
        "tiles": kw["geom"].n_ty * kw["geom"].n_tx,
        "a_planes": list(a.shape),
        "ms": cuda_ms(lambda: pt.tile_sweep_kernel(*args, **kw)),
        "plain_ms": cuda_ms(lambda: pt.tile_sweep_plain(*args, **kw),
                            reps=2, warm=1),
        "bound_ms": bound_ms(flops, nbytes),
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
    }


def timed_once(fn):
    """(result, milliseconds) of one call of `fn`, by CUDA events, the
    start event behind `busy_queue` as in `cuda_ms`."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy_queue()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def k2_chunk(n_a):
    """Query rows per chunk of K2's plain version and library call
    against `n_a` A rows: the largest power of two whose (chunk, n_a)
    temporaries, 16 bytes a distance (bf16 and float32 products, the
    scaled copy, the sum), fit in 80 % of the card's free memory."""
    rows = 0.8 * torch.cuda.mem_get_info()[0] / (16 * n_a)
    return 1 << max(0, int(rows).bit_length() - 1)


def k2_bf16_check(f_b, f_a, idx, what):
    """K2's bf16 picks `idx` for the query rows `f_b` against the plain
    version's on the same tables (ties judged in the kernel's own metric,
    float64, 1e-5 relative); returns (plain ms, rows that differ, the
    largest metric difference)."""
    from image_analogies_tpu_torch.kernels import nn_brute as nb

    bf = torch.bfloat16
    a_sq = nb.squared_norms(f_a)
    plain, plain_ms = timed_once(lambda: nb.nn_argmin_plain(
        f_b, f_a, a_sq, k2_chunk(f_a.shape[0]), bf))
    m_k = nb.argmin_metric(f_b, f_a, a_sq, idx, bf)
    m_p = nb.argmin_metric(f_b, f_a, a_sq, plain, bf)
    differ = idx != plain
    if bool((differ & ((m_k - m_p).abs() > 1e-5 * m_p.abs())).any()):
        raise AssertionError(f"{what}: K2 bf16 differs from its plain "
                             "version off ties")
    return plain_ms, int(differ.sum()), float((m_k - m_p).abs().max())


def lean_k2_row(f_b, f_a, idx):
    """K2 (bf16 rows) on one launch of the lean oracle as the main path
    made it, whole: its picks against the plain version's, and kernel,
    plain and library (bf16 `matmul` + `argmin` in `k2_chunk` query
    chunks) times of that launch."""
    from image_analogies_tpu_torch.kernels import nn_brute as nb

    plain_ms, differ, err = k2_bf16_check(f_b, f_a, idx, "lean oracle")
    a_sq = nb.squared_norms(f_a)
    n_b, d = f_b.shape
    n_a = f_a.shape[0]
    chunk = k2_chunk(n_a)

    def library():
        out = []
        for c in range(0, n_b, chunk):
            dot = torch.matmul(f_b[c:c + chunk], f_a.T).float()
            out.append(torch.argmin(a_sq[None, :] - 2.0 * dot, dim=-1))
        return torch.cat(out)

    ms = cuda_ms(lambda: nb.nn_argmin_kernel(f_b, f_a, a_sq), reps=3,
                 warm=0)
    flops = 2.0 * n_b * n_a * d
    nbytes = (n_b + n_a) * d * 2 + n_a * 4 + n_b * 4
    return {
        "shape": [n_b, n_a, d], "rows_differ": differ, "max_abs_err": err,
        "tie": "the kernel's own metric (f64) within 1e-5 rel",
        "ms": ms, "plain_ms": plain_ms,
        "library_ms": timed_once(library)[1], "chunk": chunk,
        "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
        "bound_by": "operations",
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }


def lean_k2_level0(f_b, f_a, idx, n_q=32768):
    """K2 on the lean oracle's level-0 launch: its time, whole, and its
    picks at `n_q` query rows spread over B against the plain version on
    those rows (the whole launch's plain version takes minutes)."""
    from image_analogies_tpu_torch.kernels import nn_brute as nb

    n_q = min(n_q, f_b.shape[0])
    rows = torch.linspace(0, f_b.shape[0] - 1, n_q,
                          device=f_b.device).long()
    _, differ, err = k2_bf16_check(f_b.index_select(0, rows), f_a,
                                   idx.index_select(0, rows),
                                   "lean oracle level 0")
    a_sq = nb.squared_norms(f_a)
    ms = cuda_ms(lambda: nb.nn_argmin_kernel(f_b, f_a, a_sq), reps=1,
                 warm=0)
    flops = 2.0 * f_b.shape[0] * f_a.shape[0] * f_b.shape[1]
    return {"shape": [f_b.shape[0], f_a.shape[0], f_b.shape[1]],
            "checked_rows": n_q, "rows_differ": differ, "max_abs_err": err,
            "ms": ms, "achieved_tflops": flops / (ms * 1e-3) / 1e12}


def lean_k3_row(args, out):
    """K3 on a launch the compressed lean level made, captured with its
    inputs (the LANE-padded int8 table and one chunk of indices):
    bit-equal to the plain version and to the launch's own rows, with
    kernel, plain and `index_select` times and the bytes bound (each
    index read, each row read and written)."""
    from image_analogies_tpu_torch.kernels import polish_stream as ps

    table, idx = args
    got = ps.gather_rows_kernel(table, idx)
    if not (torch.equal(got, ps.gather_rows_plain(table, idx))
            and torch.equal(got, out)):
        raise AssertionError(f"K3 rows differ from the plain version at "
                             f"{tuple(table.shape)} x {idx.numel()}")
    clamped = idx.clamp(0, table.shape[0] - 1)
    row_bytes = table.shape[1] * table.element_size()
    return {
        "table": list(table.shape), "dtype": str(table.dtype),
        "rows": idx.numel(), "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ps.gather_rows_kernel(table, idx)),
        "plain_ms": cuda_ms(lambda: ps.gather_rows_plain(table, idx)),
        "library_ms": cuda_ms(lambda: table.index_select(0, clamped)),
        "bound_ms": bound_ms(0.0, idx.numel() * (2 * row_bytes + 8)),
        "bound_by": "bytes",
    }


def phase_lean(dev, smi, script_t0, sizes=(2048, 4096, 1024)):
    """The lean path at the repo's scale sizes (SCALE), `sizes` = (2048,
    4096, 1024) on the card: 2048^2 (level 0 lean) against the same
    config forced onto the standard path and against the lean-brute
    oracle; the compressed arm (int8, 16:8, stream) at 2048^2; 4096^2
    (levels 0-1 lean); lean brute against standard brute at 1024^2;
    checkpoints written and a resume from level 1 at 2048^2; and K1
    (f32, int8), K2 (bf16) and K3 held against their plain versions at
    the lean path's shapes."""
    import dataclasses
    import shutil

    from image_analogies_tpu_torch import create_image_analogy, psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import BUILD_DIR
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.models import analogy as an
    from image_analogies_tpu_torch.models import brute
    from image_analogies_tpu_torch.utils.examples import super_resolution

    t_phase = time.perf_counter()
    big, huge, small = sizes
    rec = {"phase": "lean", "nvidia_smi": smi, "sizes": list(sizes),
           "config": {k: v for k, v in SCALE.items() if k != "device"}}
    cfg = SynthConfig(**{**SCALE, "device": dev.type})
    ex2 = super_resolution(big)
    k1_2048, _ = expected_launches(big, cfg)
    rec["lean_levels_2048"] = lean_levels(big, 6, cfg.feature_bytes_budget)
    if rec["lean_levels_2048"] != [0]:
        raise AssertionError(f"2048^2 lean levels {rec['lean_levels_2048']}")

    # 2048^2, lean level 0: the A table and one B table per EM step come
    # from assemble_features_lean.
    calls = []
    real_lean = an.assemble_features_lean

    def counting(*args, **kw):
        calls.append(tuple(args[0].shape[:2]))
        return real_lean(*args, **kw)

    an.assemble_features_lean = counting
    try:
        run_synth(ex2, cfg)
    finally:
        an.assemble_features_lean = real_lean
    if calls != [(big, big)] * (1 + cfg.em_iters):
        raise AssertionError(f"2048^2 lean assemblies {calls}")
    lean2, walls, peak, launches = timed_runs(ex2, cfg, 3, warm=False)
    want_launches(launches, "2048^2 lean", k1=k1_2048)
    rec["bp_std_2048"] = check_output(lean2, ex2[2].shape, "2048^2 lean")
    rec.update(wall_s_median_2048=statistics.median(walls),
               walls_s_2048=walls, peak_gib_2048=peak, launches_2048=launches)
    emit({"phase": "lean", "part": "2048"})

    # Checkpoints and a resume from level 1 (standard) into level 0 (lean).
    ckpt = BUILD_DIR.parent / "lean_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        saved, _ = run_synth(ex2, dataclasses.replace(
            cfg, save_level_artifacts=str(ckpt)))
        files = sorted(p.name for p in ckpt.iterdir())
        n_levels = cfg.clamp_levels((big, big))
        if files != [f"level_{i}.npz" for i in range(n_levels)]:
            raise AssertionError(f"checkpoint files {files}")
        (ckpt / "level_0.npz").unlink()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = create_image_analogy(*ex2, cfg, resume_from=str(ckpt),
                                       resume_strict=True)
        torch.cuda.synchronize()
        rec["wall_s_resumed_from_level_1"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rec["resume_max_abs_diff"] = float((resumed - lean2).abs().max())
    rec["checkpointing_run_max_abs_diff"] = float((saved - lean2).abs().max())
    if not (torch.equal(resumed, lean2) and torch.equal(saved, lean2)):
        raise AssertionError(
            f"resumed / checkpointing B' differ from the uninterrupted B' "
            f"by {rec['resume_max_abs_diff']} / "
            f"{rec['checkpointing_run_max_abs_diff']}")
    emit({"phase": "lean", "part": "resume"})

    # The same config forced onto the standard path.
    std_cfg = dataclasses.replace(cfg, feature_bytes_budget=1 << 40)
    std2, walls, peak, launches = timed_runs(ex2, std_cfg, 3)
    want_launches(launches, "2048^2 standard", k1=k1_2048)
    rec.update(wall_s_median_2048_standard=statistics.median(walls),
               walls_s_2048_standard=walls, peak_gib_2048_standard=peak,
               max_abs_diff_2048_lean_vs_standard=float(
                   (lean2 - std2).abs().max()))
    if not torch.equal(lean2, std2):
        raise AssertionError(
            "2048^2 lean B' differs from the standard path's by "
            f"{rec['max_abs_diff_2048_lean_vs_standard']}")
    emit({"phase": "lean", "part": "standard"})

    # The lean-brute oracle: K2 bf16 on every level (one B band each).
    or_cfg = SynthConfig(levels=6, matcher="brute", em_iters=2,
                         brute_lean_bytes=1, device=dev.type)
    n0 = big * big
    with capture_first(brute, "nn_argmin",
                       lambda f_b, *a, **k: f_b.shape[0] == n0) as seen, \
            capture_first(brute, "nn_argmin",
                          lambda f_b, *a, **k: f_b.shape[0] == n0 // 4) \
            as seen1:
        oracle, walls, peak, launches = timed_runs(ex2, or_cfg, 1,
                                                   warm=False)
    want_launches(launches, "2048^2 lean-brute oracle",
                  k2=or_cfg.clamp_levels((big, big)) * or_cfg.em_iters)
    rec.update(wall_s_oracle_2048=walls[0], peak_gib_oracle_2048=peak,
               k2_launches_oracle_2048=launches["k2"])
    emit({"phase": "lean", "part": "oracle"})
    f_b, f_a, *_ = seen1[0][0]
    rec["k2_2048_oracle_level1"] = lean_k2_row(f_b, f_a, seen1[0][2])
    emit({"phase": "lean", "part": "k2_level1"})
    f_b, f_a, *_ = seen[0][0]
    rec["k2_2048_oracle_level0"] = lean_k2_level0(f_b, f_a, seen[0][2])
    emit({"phase": "lean", "part": "k2_level0"})
    del seen, seen1, f_b, f_a
    p_lean, p_std = psnr(lean2, oracle), psnr(std2, oracle)
    rec.update(psnr_2048_lean_vs_oracle=p_lean,
               psnr_2048_standard_vs_oracle=p_std,
               psnr_2048_lean_vs_standard=psnr(lean2, std2),
               psnr_2048_lean_meets_35=bool(p_lean >= 35.0))
    if not p_lean >= 33.0:
        raise AssertionError(f"2048^2 lean PSNR vs oracle {p_lean} < 33 dB")
    if not p_lean >= p_std - 3.0:
        raise AssertionError(f"2048^2 lean PSNR {p_lean} more than 3 dB "
                             f"below the standard path's {p_std}")

    # The compressed arm at 2048^2, with its lean level's first K1 (int8)
    # and K3 launches captured in the warm run.
    from image_analogies_tpu_torch.kernels import polish_stream as ps

    with Modes("int8", "16:8", "stream"):
        with capture_first(pt, "tile_sweep",
                           lambda *a, **k: k["ha"] == big) as k1_seen, \
                capture_first(ps, "gather_rows",
                              lambda t, *a, **k: t.shape[0] == n0) as k3_seen:
            run_synth(ex2, cfg)
        comp, walls, peak, launches = timed_runs(ex2, cfg, 1, warm=False)
    k1c, k3c = expected_launches(big, cfg, stream=True)
    want_launches(launches, "2048^2 compressed", k1_int8=k1c, k3=k3c)
    p_comp = psnr(comp, oracle)
    rec.update(wall_s_2048_compressed=walls[0], peak_gib_2048_compressed=peak,
               launches_2048_compressed=launches,
               psnr_2048_compressed_vs_oracle=p_comp,
               psnr_2048_compressed_meets_35=bool(p_comp >= 35.0))
    if not p_comp >= 33.0:
        raise AssertionError(f"2048^2 compressed PSNR vs oracle {p_comp} "
                             "< 33 dB")
    args, kw, _ = k1_seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    rec["k1_int8_2048_compressed_first_sweep"] = lean_k1_row(
        one_frame(args), kw, (big, big),
        "K1 int8 on the 2048^2 compressed lean level")
    args, _, out = k3_seen[0]
    rec["k3_2048_compressed_first_launch"] = lean_k3_row(args, out)
    del k1_seen, k3_seen, args, out
    emit({"phase": "lean", "part": "compressed"})
    del lean2, std2, oracle, comp, saved, resumed

    # 4096^2: levels 0 and 1 lean; K1's first level-0 sweep captured.
    ex4 = super_resolution(huge)
    rec["lean_levels_4096"] = lean_levels(huge, 6, cfg.feature_bytes_budget)
    if rec["lean_levels_4096"] != [0, 1]:
        raise AssertionError(f"4096^2 lean levels {rec['lean_levels_4096']}")
    k1_4096, _ = expected_launches(huge, cfg)
    with capture_first(pt, "tile_sweep",
                       lambda *a, **k: k["ha"] == huge) as seen:
        _, warm_wall = run_synth(ex4, cfg)
    reps = 2 if time.perf_counter() - script_t0 + 3 * warm_wall < 600 else 1
    out4, walls, peak, launches = timed_runs(ex4, cfg, reps, warm=False)
    want_launches(launches, "4096^2 lean", k1=k1_4096)
    if not bool(torch.isfinite(out4).all()) or float(out4.min()) < 0.0 \
            or float(out4.max()) > 1.0:
        raise AssertionError("4096^2 B' not finite in [0, 1]")
    rec.update(wall_s_4096_warm_first=warm_wall, walls_s_4096=walls,
               wall_s_median_4096=statistics.median(walls),
               peak_gib_4096=peak, launches_4096=launches,
               bp_std_4096=float(out4.std()))
    del out4
    args, kw, _ = seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    rec["k1_4096_first_sweep"] = lean_k1_row(
        one_frame(args), kw, (huge, huge), "K1 f32 on the 4096^2 lean level")
    del seen, args
    emit({"phase": "lean", "part": "4096"})

    # Lean brute against standard brute at 1024^2.
    ex1 = super_resolution(small)
    b_cfg = SynthConfig(levels=5, matcher="brute", em_iters=2,
                        device=dev.type)
    bstd, wall_std = run_synth(ex1, b_cfg)
    blean, wall_lean = run_synth(ex1, dataclasses.replace(
        b_cfg, brute_lean_bytes=1))
    p_b = psnr(blean, bstd)
    rec.update(wall_s_1024_brute_standard=wall_std,
               wall_s_1024_brute_lean=wall_lean,
               psnr_1024_lean_brute_vs_standard=p_b)
    if not p_b >= 33.0:
        raise AssertionError(f"1024^2 lean brute vs standard {p_b} < 33 dB")
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# BASELINE config 5 as bench.py:680-708 runs it: 8 frames of 1024^2,
# 4 resident a chunk, against the brute oracle at one frame a step; the
# gate is 1 dB under the reference's own record against its oracle
# (32.34-32.37 dB), the random streams differing by design.
CONFIG5 = dict(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
               device="cuda")
CONFIG5_FRAMES, CONFIG5_SIZE, CONFIG5_FPS = 8, 1024, 4
CONFIG5_MIN_PSNR = 31.3


def run_batch(a, ap, frames, cfg, **kw):
    """(B', wall) of one `synthesize_batch` call, host clock around work
    that ends in a synchronize."""
    from image_analogies_tpu_torch import synthesize_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = synthesize_batch(a, ap, frames, cfg, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def batch_k1_launches(cfg, size, n_frames, fps):
    """K1 launches of one batch run: per chunk of resident frames, one a
    sweep, em_iters x pm_iters (size-aware) per tile level."""
    return expected_launches(size, cfg)[0] * -(-n_frames // fps)


def k1_frames_row(args, kw):
    """K1's frame-axis launch captured from config 5 (a 4-frame chunk's
    first level-0 sweep): each frame bit-equal to its single-frame
    launch and held against the plain version (distances within rtol
    1e-4 / atol 1e-5, `unexplained_offsets` finds 0); the batched launch
    timed against the single-frame launches, the plain version, and the
    bound of the whole launch (each input read once)."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    a, b = args[0], args[1]
    n_f = b.shape[0]
    per_frame = [(a,) + tuple(t[i] for t in args[1:]) for i in range(n_f)]
    got = pt.tile_sweep_kernel(*args, **kw)
    want = pt.tile_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    geo = {k: v for k, v in kw.items() if k != "coh_factor"}
    h = w = CONFIG5_SIZE
    bad = errs = 0
    max_err = 0.0
    for i in range(n_f):
        one = pt.tile_sweep_kernel(*per_frame[i], **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g[i], o) for g, o in zip(got, one)):
            raise AssertionError(f"K1 frame axis: frame {i} differs from "
                                 "its single-frame launch")
        kd, pd = got[2][i][:h, :w], want[2][i][:h, :w]
        errs += int((~((kd - pd).abs() <= 1e-5 + 1e-4 * pd.abs())).sum())
        max_err = max(max_err, float((kd - pd).abs().max()))
        bad += int(pt.unexplained_offsets(
            [t[i] for t in got], [t[i] for t in want],
            [t[i] for t in args[5:8]], a, b[i], h=h, w=w, **geo).sum())
    if errs or bad:
        raise AssertionError(f"K1 frame axis vs plain: {errs} distances off "
                             f"tolerance, {bad} unexplained offsets")
    _, flops, nbytes = k1_flops_bytes(args, kw, a.element_size())
    return {
        "frames": n_f, "tiles": kw["geom"].n_ty * kw["geom"].n_tx,
        "valid_slots": int((args[4] > 0).sum()),
        "max_abs_err": max_err, "unexplained_offsets": bad,
        "bit_equal_to_single_frame_launches": True,
        "ms": cuda_ms(lambda: pt.tile_sweep_kernel(*args, **kw)),
        "single_frame_launches_ms": cuda_ms(
            lambda: [pt.tile_sweep_kernel(*f, **kw) for f in per_frame]),
        "plain_ms": cuda_ms(lambda: pt.tile_sweep_plain(*args, **kw),
                            reps=2, warm=1),
        "bound_ms": bound_ms(flops, nbytes),
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def phase_batch(dev, smi):
    """BASELINE config 5 through `synthesize_batch`: 8 frames of 1024^2
    (`npr_frames`), 4 resident a chunk (level 0 lean: four B tables and
    the A table pass the 2 GiB budget), the median of 3 warm walls, the
    peak, K1 launches (one a sweep a chunk), PSNR against the brute
    oracle at one frame a step; isolation (1 and 2 frames a step give
    the same B', a batched frame with frame_indices 0 is its solo run);
    and K1's frame-axis row."""
    import dataclasses

    from image_analogies_tpu_torch import psnr, synthesize_batch
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.models.analogy import _feature_table_bytes
    from image_analogies_tpu_torch.parallel.batch import stack_stats
    from image_analogies_tpu_torch.utils.examples import npr_frames

    t_phase = time.perf_counter()
    n, size, fps = CONFIG5_FRAMES, CONFIG5_SIZE, CONFIG5_FPS
    a, ap, frames = npr_frames(n_frames=n, size=size)
    cfg = SynthConfig(**{**CONFIG5, "device": dev.type})
    want_k1 = batch_k1_launches(cfg, size, n, fps)
    rec = {"phase": "batch", "nvidia_smi": smi, "frames": n, "size": size,
           "frames_per_step": fps,
           "config": {k: v for k, v in CONFIG5.items() if k != "device"},
           "level0_lean_at": {
               str(f): _feature_table_bytes(size, size, size, size, f)
               > cfg.feature_bytes_budget for f in (1, 2, 4)}}
    if rec["level0_lean_at"] != {"1": False, "2": False, "4": True}:
        raise AssertionError(f"level-0 plans {rec['level0_lean_at']}")

    # Warm run, capturing the first level-0 sweep of a 4-frame chunk.
    with capture_first(pt, "tile_sweep", lambda *a_, **k: (
            a_[1].ndim == 4 and a_[1].shape[0] == fps
            and k["ha"] == size)) as seen:
        run_batch(a, ap, frames, cfg, frames_per_step=fps)
    if not seen:
        raise AssertionError("config 5 made no 4-frame level-0 sweep")
    args, kw, _ = seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, launches, out4 = [], [], None
    for _ in range(3):
        pt.launches.reset()
        out4, wall = run_batch(a, ap, frames, cfg, frames_per_step=fps)
        walls.append(wall)
        launches.append(pt.launches.count)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if launches != [want_k1] * 3:
        raise AssertionError(f"config 5 K1 launches {launches}, not "
                             f"{want_k1} a run")
    rec.update(wall_s_median=statistics.median(walls), walls_s=walls,
               peak_gib=peak, k1_launches_per_run=launches[0],
               k1_launches_one_per_frame=batch_k1_launches(cfg, size, n, 1),
               bp_std=check_output(out4, frames.shape, "config 5"))
    emit({"phase": "batch", "part": "walls"})

    # The oracle: brute at one frame a step (K2 f32 on every level).
    from image_analogies_tpu_torch.kernels import nn_brute

    oracle_cfg = dataclasses.replace(cfg, matcher="brute")
    nn_brute.launches.reset()
    oracle, rec["oracle_wall_s"] = run_batch(a, ap, frames, oracle_cfg,
                                             frames_per_step=1)
    rec["oracle_k2_launches"] = nn_brute.launches.count
    rec["psnr_db"] = psnr(out4, oracle)
    rec["psnr_db_per_frame"] = [psnr(out4[i], oracle[i]) for i in range(n)]
    if not rec["psnr_db"] >= CONFIG5_MIN_PSNR:
        raise AssertionError(f"config 5 PSNR {rec['psnr_db']} < "
                             f"{CONFIG5_MIN_PSNR} dB")
    emit({"phase": "batch", "part": "oracle"})

    # Isolation: chunking (same plans at 1 and 2 frames a step), and a
    # batched frame keyed as frame 0 against its solo run.
    out1, rec["wall_s_fps1"] = run_batch(a, ap, frames, cfg,
                                         frames_per_step=1)
    out2, rec["wall_s_fps2"] = run_batch(a, ap, frames, cfg,
                                         frames_per_step=2)
    if not torch.equal(out1, out2):
        raise AssertionError(
            "config 5: 1 and 2 frames a step differ by "
            f"{float((out1 - out2).abs().max())}")
    p41 = psnr(out4, out1)
    rec["fps4_vs_fps1"] = {
        "max_abs_diff": float((out4 - out1).abs().max()),
        "psnr_db": p41 if math.isfinite(p41) else None,  # None: equal
        "frames_differing": int(sum(not torch.equal(out4[i], out1[i])
                                    for i in range(n))),
    }
    stats = stack_stats(
        torch.as_tensor(np.asarray(frames, np.float32), device=dev), cfg)
    keyed = synthesize_batch(a, ap, frames, cfg, frames_per_step=2,
                             frame_indices=[0] * n)
    for i in range(n):
        solo = synthesize_batch(a, ap, frames[i:i + 1], cfg, _b_stats=stats)
        if not torch.equal(keyed[i], solo[0]):
            raise AssertionError(f"config 5: frame {i} keyed as frame 0 "
                                 "differs from its solo run")
    rec["isolation"] = "fps 1 == fps 2; frame_indices=[0]*8 == solo runs"
    emit({"phase": "batch", "part": "isolation"})

    rec["k1_frames"] = k1_frames_row(args, kw)
    emit({"phase": "batch", "part": "k1_frames"})
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# tools/video_bench.py's protocol and VIDEO_r14's config, at 1024^2; its
# gates are tools/check_video.py's.
VIDEO = dict(levels=3, pm_iters=4, em_iters=2, seed=0, matcher="patchmatch",
             device="cuda")
VIDEO_FRAMES, VIDEO_SIZE, VIDEO_TAU = 8, 1024, 0.1
WARM_COST_RATIO_MAX = 0.6
QUALITY_DELTA_DB_MIN = -0.1


def make_scene(size: int, frames: int, seed: int):
    """tools/video_bench.py's static scene: a random A, A' its 3x3 box
    blur recoloured, and one random B repeated `frames` times."""
    rng = np.random.default_rng(seed)
    a = rng.random((size, size, 3)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    ap = a.copy()
    for c in range(3):
        col = a[..., c]
        pad = np.pad(col, 1, mode="edge")
        acc = np.zeros_like(col)
        for dy in range(3):
            for dx in range(3):
                acc += k[dy, dx] * pad[dy:dy + size, dx:dx + size]
        ap[..., c] = acc
    ap = np.clip(0.85 * ap + 0.15 * ap[..., ::-1], 0.0, 1.0)
    b = rng.random((size, size, 3)).astype(np.float32)
    return a, ap, np.repeat(b[None], frames, axis=0)


def stream_pass(dev, a, ap, stack, cfg, warm, steps=None):
    """One frame-at-a-time pass through `VideoStream` over the frames
    `steps` of `stack` (default: all; the remap statistics are always the
    whole stack's): (outputs, per-frame walls, the stream)."""
    from image_analogies_tpu_torch.parallel.batch import stack_stats
    from image_analogies_tpu_torch.video import (
        VideoStream,
        set_warm_mode,
        warm_mode,
    )

    prev = warm_mode()
    set_warm_mode(warm)
    try:
        stream = VideoStream(
            a, ap, cfg=cfg, n_stack=stack.shape[0],
            b_stats=stack_stats(
                torch.as_tensor(np.asarray(stack, np.float32), device=dev),
                cfg))
        outs, walls = [], []
        for t in range(stack.shape[0]) if steps is None else steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(stream.step(stack[t]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        set_warm_mode(prev)
    return torch.stack(outs), walls, stream


def phase_video(dev, smi):
    """The video bench's four passes at 1024^2, 8 static frames: cold
    (warm off), warm (tau 0), warm_tau (tau 0.1) and the brute oracle
    (warm off; frames 0 and 7 stepped, equal, standing for all), with
    tools/check_video.py's gates raised on, and warm
    frame 0 and the warm-off pass held bit for bit against
    `synthesize_batch(frames_per_step=1)`."""
    import dataclasses

    from image_analogies_tpu_torch import psnr, synthesize_batch
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import nn_brute
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.video import flicker_metric

    t_phase = time.perf_counter()
    n, size = VIDEO_FRAMES, VIDEO_SIZE
    cfg = SynthConfig(**{**VIDEO, "device": dev.type})
    a, ap, stack = make_scene(size, n, cfg.seed)
    rec = {"phase": "video", "nvidia_smi": smi, "frames": n, "size": size,
           "config": {**{k: v for k, v in VIDEO.items() if k != "device"},
                      "tau": VIDEO_TAU}}
    stream_pass(dev, a, ap, stack[:2], cfg, "on")  # warm-up
    passes = {}
    # The scene is one B repeated and the brute oracle draws nothing, so
    # its frames are equal: the oracle pass steps the first frame and the
    # last (held equal bit for bit), and the others take the first's.
    oracle_steps = (0, n - 1)
    for name, c, warm in (
            ("cold", cfg, "off"), ("warm", cfg, "on"),
            ("warm_tau", dataclasses.replace(cfg, tau=VIDEO_TAU), "on"),
            ("oracle", dataclasses.replace(cfg, matcher="brute"), "off")):
        pt.launches.reset()
        nn_brute.launches.reset()
        steps = oracle_steps if name == "oracle" else None
        out, walls, stream = stream_pass(dev, a, ap, stack, c, warm, steps)
        if steps is not None:
            if not torch.equal(out[0], out[-1]):
                raise AssertionError(
                    f"video oracle: frames {steps} differ by "
                    f"{float((out[0] - out[-1]).abs().max())}")
            out = out[[0] * n]
        check_output(out, stack.shape, f"video {name}")
        passes[name] = out
        rec[name] = {
            "wall_s_per_frame": walls, "total_wall_s": sum(walls),
            "warm_frames": stream.warm_frames,
            "schedules": [list(s) for s in stream.schedules],
            "deltas": stream.deltas,
            "run_units": stream.run_units, "cold_units": stream.cold_units,
            "k1_launches": pt.launches.count,
            "k2_launches": nn_brute.launches.count,
            "frames_stepped": list(steps or range(n)),
        }
    emit({"phase": "video", "part": "passes"})
    warm = rec["warm"]
    warm["warm_cost_ratio"] = warm["run_units"] / warm["cold_units"]
    p_cold = [psnr(passes["cold"][t], passes["oracle"][t]) for t in range(n)]
    p_warm = [psnr(passes["warm"][t], passes["oracle"][t]) for t in range(n)]
    deltas = [w - c for w, c in zip(p_warm, p_cold)]
    rec["quality"] = {"psnr_cold_db": p_cold, "psnr_warm_db": p_warm,
                      "mean_delta_db": float(np.mean(deltas)),
                      "min_delta_db": float(np.min(deltas))}
    rec["flicker"] = {k: flicker_metric(passes[key].cpu().numpy())
                      for k, key in (("independent", "cold"),
                                     ("warm", "warm"),
                                     ("warm_tau", "warm_tau"))}
    fails = []
    for name in ("warm", "warm_tau"):
        if rec[name]["warm_frames"] != n - 1:
            fails.append(f"{name}.warm_frames {rec[name]['warm_frames']}")
    if not 0.0 < warm["warm_cost_ratio"] <= WARM_COST_RATIO_MAX:
        fails.append(f"warm_cost_ratio {warm['warm_cost_ratio']}")
    if not rec["quality"]["mean_delta_db"] >= QUALITY_DELTA_DB_MIN:
        fails.append(f"mean_delta_db {rec['quality']['mean_delta_db']}")
    if not rec["flicker"]["warm_tau"] < rec["flicker"]["independent"]:
        fails.append(f"flicker {rec['flicker']}")
    ref = synthesize_batch(a, ap, stack, cfg, frames_per_step=1)
    if not torch.equal(passes["warm"][0], ref[0]):
        fails.append("warm frame 0 differs from the batch runner's")
    if not torch.equal(passes["cold"], ref):
        fails.append("the warm-off pass differs from frames_per_step=1")
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    if fails:
        raise AssertionError("video gates: " + "; ".join(fails))
    return rec


# The command line's phase.  The CLI has no polish flag (nor has the
# reference's), so its headline keeps the default polish: the library
# call it is held against runs the same config.
CLI_HEADLINE = ["--levels", "5", "--matcher", "patchmatch", "--em-iters",
                "2", "--pm-iters", "6"]
# BASELINE configs 2 and 4 as bench.py:646-676 runs them, each against
# its brute oracle on the same knobs.  Config 2's content is
# self-similar: the reference recorded 31.66 dB for it against its
# oracle (KAPPA_r05.json, BENCH_r05.json), under the 33 dB of the other
# configs; its gate is 1 dB under that record, as config 5's is, and
# whether it reaches 33 dB is reported beside it.
CONFIG2 = dict(levels=5, matcher="patchmatch", em_iters=2, kappa=5.0)
CONFIG4 = dict(levels=5, matcher="patchmatch", em_iters=3, steerable=True,
               color_mode="luminance")
CONFIG2_MIN_PSNR, CONFIG4_MIN_PSNR, SYNTH_GATE_DB = 30.66, 33.0, 33.0
# Config 1's inputs for the ann matcher, against its brute B'.
CONFIG1 = dict(levels=3, matcher="brute", em_iters=2)
CHAOS_PLANS = ("level:1:raise", "kernel:0:raise")


def run_cli(args, env=None, timeout=900):
    """One `python -m image_analogies_tpu_torch.cli` process from the
    repository root: (its wall in seconds, its stdout); raises on a
    non-zero exit."""
    return run_cli_module("image_analogies_tpu_torch.cli", args, env,
                          timeout)


def run_cli_module(module, args, env=None, timeout=900):
    """`run_cli` for any module of the port run with `python -m`."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=root, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **(env or {})},
    )
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(args[:1])} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    return wall, res.stdout


def cli_events(progress_path):
    with open(progress_path) as f:
        return [json.loads(line) for line in f]


def cli_done_wall(progress_path):
    """The `done` event's wall of a CLI run's progress stream: from the
    loaded images to B' on the host."""
    return [e for e in cli_events(progress_path)
            if e["event"] == "done"][-1]["wall_s"]


def cli_level_walls(progress_path):
    """The prologue's and each level's wall (ms) of a CLI run, in order
    (a supervised retry's levels follow the failed attempt's)."""
    return [(e["event"] if e["event"] == "prologue" else e["level"],
             e["wall_ms"]) for e in cli_events(progress_path)
            if e["event"] in ("prologue", "level_done")]


def synth_args(d, family, out, *extra):
    return ["synth", "--a", f"{d}/{family}_A.png", "--ap",
            f"{d}/{family}_Ap.png", "--b", f"{d}/{family}_B.png", "--out",
            out, *extra]


def png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def assets(d, family):
    from image_analogies_tpu_torch.utils.io import load_image

    return tuple(load_image(f"{d}/{family}_{t}.png") for t in ("A", "Ap", "B"))


def config_row(name, ex, kw, min_psnr, capture=None):
    """One BASELINE config on the card: a warm run (capturing the first
    K1 launch that satisfies `capture`), the median of 3 warm walls with
    the peak memory and the K1 launches of each run, then the brute
    oracle on the same knobs (its K2 launches) and the PSNR, gated at
    `min_psnr`.  Returns (record, captured launch or None)."""
    from image_analogies_tpu_torch import psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import nn_brute
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    cfg = SynthConfig(**kw)
    seen = []
    if capture is not None:
        with capture_first(pt, "tile_sweep", capture) as seen:
            run_synth(ex, cfg)
    else:
        run_synth(ex, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, k1 = [], []
    for _ in range(3):
        pt.launches.reset()
        out, wall = run_synth(ex, cfg)
        walls.append(wall)
        k1.append(pt.launches.count)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if len(set(k1)) != 1 or k1[0] == 0:
        raise AssertionError(f"{name}: K1 launches {k1}")
    nn_brute.launches.reset()
    oracle, oracle_wall = run_synth(ex, SynthConfig(
        **{**kw, "matcher": "brute"}))
    k2 = nn_brute.launches.count
    value = psnr(out, oracle)
    rec = {"config": kw, "wall_s_median": statistics.median(walls),
           "walls_s": walls, "peak_gib": peak, "k1_launches_per_run": k1[0],
           "oracle_wall_s": oracle_wall, "oracle_k2_launches": k2,
           "psnr_db": value, "psnr_gate_db": min_psnr,
           "meets_33_db": bool(value >= SYNTH_GATE_DB),
           "bp_std": check_output(out, ex[2].shape, name)}
    if not value >= min_psnr:
        raise AssertionError(f"{name}: PSNR {value} < {min_psnr} dB")
    return rec, (seen[0] if seen else None)


def phase_cli(dev, smi, l2_rate, sizes=(1024, 512, 256)):
    """The port's command line as a user runs it, in subprocesses, on
    assets its `examples` wrote: the headline through `synth` with
    --trace-dir, --progress and --profile (its PNG equal to the library
    call's B' on the same inputs, the span tree, the counters and the
    kernel launches of its metrics.json, the torch.profiler trace);
    BASELINE configs 2 and 4 against their brute oracles (library calls
    on the same assets) with K1's launch at steerable width captured from
    config 4 and held against its plain version; `--matcher ann` on
    config 1's inputs against the brute oracle; and `--supervise` healing
    an injected level fault and kernel fault bit-identically.  `sizes`
    (headline and config 4, config 2, ann) are the configs' own; smaller
    ones rehearse the phase on the CPU."""
    import os
    import shutil

    from image_analogies_tpu_torch import create_image_analogy, psnr
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.utils import native
    from image_analogies_tpu_torch.utils.io import load_image, to_uint8

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rec = {"phase": "cli", "nvidia_smi": smi, "sizes": list(sizes)}
    device = dev.type
    big, mid, small = sizes
    # The three asset sets at once: host work, no card.
    dirs = {size: f"{work}/ex{size}" for size in sizes}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "examples",
         "--out", d, "--size", str(size)], cwd=root,
        stdout=subprocess.DEVNULL) for size, d in dirs.items()]
    codes = [proc.wait(timeout=600) for proc in procs]
    if any(codes):
        raise AssertionError(f"cli examples exited {codes}")

    # The headline: the library on the written assets, then the CLI.
    sr = assets(dirs[big], "super_resolution")
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2,
                      pm_iters=6, device=device)
    run_synth(sr, cfg)
    lib_walls = []
    for _ in range(3):
        pt.launches.reset()
        lib_out, wall = run_synth(sr, cfg)
        lib_walls.append(wall)
        lib_k1 = pt.launches.count
    td, prof, prog = f"{work}/td", f"{work}/prof", f"{work}/headline.jsonl"
    out = f"{work}/headline.png"
    proc_wall, _ = run_cli(synth_args(
        dirs[big], "super_resolution", out, *CLI_HEADLINE, "--device",
        device, "--trace-dir", td, "--progress", prog, "--profile", prof))
    got, want = png(out), to_uint8(lib_out)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"CLI headline PNG differs from the library's B' at "
            f"{int((got != want).sum())} values")
    with open(f"{td}/host_spans.json") as f:
        (run,) = [s for s in json.load(f)["spans"] if s["name"] == "run"]
    n_lv = cfg.clamp_levels((big, big))  # 5 at 1024^2
    levels = [s for s in run["children"] if s["name"] == "level"]
    if [s["attrs"]["level"] for s in levels] != list(range(n_lv))[::-1] \
            or any(s["attrs"]["em_iters"] != 2 or [c["name"] for c in s.get(
                "children", [])] != ["em_iter"] * 2 for s in levels):
        raise AssertionError(f"CLI headline: span tree is not {n_lv} "
                             "levels of 2 EM steps")
    with open(f"{td}/metrics.json") as f:
        metrics = json.load(f)
    counted = {
        "levels": metrics["ia_levels_total"]["values"]["total"],
        "em_iters": metrics["ia_em_iters_total"]["values"]["total"],
        "tile_sweep_launches": metrics["ia_kernel_launches_total"][
            "values"]['{kernel="tile_sweep"}'],
    }
    if counted != {"levels": n_lv, "em_iters": 2 * n_lv,
                   "tile_sweep_launches": lib_k1} \
            or lib_k1 != expected_launches(big, cfg)[0]:
        raise AssertionError(f"CLI headline metrics {counted}, library "
                             f"K1 launches {lib_k1}")
    with open(f"{prof}/torch_trace.json") as f:
        trace = f.read()
    # The reference's scope tags as profiler ranges, and K1 by name.
    names = [f'"{n}"' for n in ("tlm_prologue", "tlm_L0", "tlm_em1",
                                "tlm_match")]
    if device == "cuda":
        names.append("tile_sweep_kernel<")  # "void tile_sweep_kernel<...>"
    for name in names:
        if name not in trace:
            raise AssertionError(f"CLI profile names no {name}")
    rec["headline"] = {
        "png_equals_library": True, "metrics": counted,
        "library_k1_launches": lib_k1,
        "library_wall_s_median": statistics.median(lib_walls),
        "library_walls_s": lib_walls, "cli_wall_s": cli_done_wall(prog),
        "cli_process_wall_s": proc_wall,
        "trace_bytes": os.path.getsize(f"{prof}/torch_trace.json"),
    }
    emit({"phase": "cli", "part": "headline", **rec["headline"]})

    # Configs 2 and 4; K1 at steerable width from config 4's level 0.
    rec["config2"], _ = config_row(
        "config 2", assets(dirs[mid], "artistic_filter"),
        {**CONFIG2, "device": device}, CONFIG2_MIN_PSNR)
    rec["config4"], seen = config_row(
        "config 4", sr, {**CONFIG4, "device": device}, CONFIG4_MIN_PSNR,
        capture=lambda *a, **k: k["ha"] == big)
    if seen is None:
        raise AssertionError("config 4 made no level-0 tile sweep")
    args, kw, _ = seen
    args = one_frame(args)
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    _, stats = k1_check(args, kw, "K1 at steerable width", hw=(big, big))
    row = {**stats, "channels": len(kw["specs"]), **k1_timing(args, kw,
                                                              l2_rate)}
    rec["k1_steerable"] = row
    emit({"phase": "cli", "part": "configs", "config2": rec["config2"],
          "config4": rec["config4"], "k1_steerable": row})

    # ann on config 1's inputs: on the brute run's first coarsest-level
    # tables (the same inputs for both matchers) the eps-0 tree's picks
    # are exact and differ from K2's only at ties (the K2 tie rule); end
    # to end, eps 0.5 with 12 PCA dims against brute with 12.  (The eps-0
    # run end to end, 30 s of host tree queries, is cut to keep the
    # script inside its time limit; tests/test_torch_ann.py holds it.)
    from image_analogies_tpu_torch.models import brute as brute_mod
    from image_analogies_tpu_torch.models.ann import _host_ann_query

    if not native.ann_available():
        raise AssertionError("the native kd-tree did not build")
    tbn = assets(dirs[small], "texture_by_numbers")
    n_coarse = (small // 4) ** 2
    with capture_first(brute_mod, "nn_argmin",
                       lambda f_b, *a, **k: f_b.shape[0] == n_coarse) as seen:
        create_image_analogy(*tbn, SynthConfig(**CONFIG1, device=device))
    (f_b, f_a), k2_idx = seen[0][0][:2], seen[0][2]
    tree_idx, _ = _host_ann_query(f_b.float().cpu().numpy(),
                                  f_a.float().cpu().numpy(), 0.0)
    tree_idx = torch.as_tensor(tree_idx, device=f_b.device).long()
    tree_off = k2_exactness(f_b.float(), f_a.float(), tree_idx)
    k2_off = k2_exactness(f_b.float(), f_a.float(), k2_idx)
    if tree_off[1] or k2_off[1]:
        raise AssertionError(f"ann eps 0 vs K2 on the coarsest tables: "
                             f"off the tie rule {tree_off} / {k2_off}")
    coarsest = {"rows": n_coarse,
                "picks_differing": int((tree_idx != k2_idx).sum()),
                "tree_beyond_rtol": tree_off[0], "k2_beyond_rtol": k2_off[0]}
    ann_args = ["--levels", "3", "--em-iters", "2", "--matcher", "ann",
                "--device", device]
    prog1 = f"{work}/ann1.jsonl"
    run_cli(synth_args(dirs[small], "texture_by_numbers", f"{work}/ann1.png",
                       *ann_args, "--ann-eps", "0.5", "--pca-dims", "12",
                       "--progress", prog1))
    brute12 = create_image_analogy(*tbn, SynthConfig(
        **CONFIG1, pca_dims=12, device=device))
    rec["ann"] = {
        "eps0_coarsest_tables_vs_k2": coarsest,
        "eps05_pca12_wall_s": cli_done_wall(prog1),
        "eps05_pca12_psnr_vs_brute_pca12_db": psnr(
            load_image(f"{work}/ann1.png"), to_uint8(brute12) / 255.0),
    }
    emit({"phase": "cli", "part": "ann", **rec["ann"]})

    # Chaos: --supervise under injected faults heals bit-identically.
    chaos = {}
    for arm, plan in (("plain", None), ("supervised", None),
                      *((p, p) for p in CHAOS_PLANS)):
        i = len(chaos)
        out, prog, tdir = (f"{work}/chaos_{i}.png", f"{work}/chaos_{i}.jsonl",
                           f"{work}/chaos_td_{i}")
        extra = [] if arm == "plain" else ["--supervise"]
        if plan:
            extra += ["--trace-dir", tdir]
        proc_wall, _ = run_cli(synth_args(
            dirs[big], "super_resolution", out, *CLI_HEADLINE, "--device",
            device, "--progress", prog, *extra),
            env={"IA_FAULT_PLAN": plan} if plan else None)
        chaos[arm] = {"wall_s": cli_done_wall(prog),
                      "walls_ms": cli_level_walls(prog),
                      "process_wall_s": proc_wall}
        if not np.array_equal(png(out), want):
            raise AssertionError(f"chaos {arm}: B' differs from the "
                                 "unfaulted run")
        if plan:
            with open(f"{tdir}/metrics.json") as f:
                m = json.load(f)
            chaos[arm].update(
                retries=sum(m["ia_retries_total"]["values"].values()),
                injections=sum(
                    m["ia_fault_injections_total"]["values"].values()))
            if chaos[arm]["retries"] != 1 or chaos[arm]["injections"] != 1:
                raise AssertionError(f"chaos {arm}: {chaos[arm]}")
    chaos["supervisor_overhead_s"] = (chaos["supervised"]["wall_s"]
                                      - chaos["plain"]["wall_s"])
    # The same three ways in this warm process, apart from a cold
    # process's first-use costs: traced, traced with the checkpoints
    # the supervisor forces, and supervised (an attempt thread).
    import dataclasses

    from image_analogies_tpu_torch.runtime.supervisor import supervise
    from image_analogies_tpu_torch.telemetry import Tracer

    ckpt_cfg = dataclasses.replace(cfg, save_level_artifacts=f"{work}/ck")
    arms = {
        "traced": lambda: create_image_analogy(*sr, cfg, progress=Tracer()),
        "checkpointed": lambda: create_image_analogy(
            *sr, ckpt_cfg, progress=Tracer()),
        "supervised": lambda: supervise(
            lambda resume: create_image_analogy(
                *sr, ckpt_cfg, progress=Tracer(), resume_from=resume),
            ckpt_dir=f"{work}/ck"),
    }
    warm = {name: [] for name in arms}
    for _ in range(3):
        for name, fn in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            warm[name].append(time.perf_counter() - t0)
            if not np.array_equal(to_uint8(out), want):
                raise AssertionError(f"warm {name}: B' differs")
    chaos["warm_in_process_walls_s"] = warm
    rec["chaos"] = chaos
    emit({"phase": "cli", "part": "chaos", **chaos})
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "cli", "part": "done", "phase_wall_s":
          rec["phase_wall_s"]})
    return rec


TELEMETRY_COMPRESSED_ENV = {"IA_CAND_DTYPE": "int8", "IA_CAND_PRUNE": "16:8",
                            "IA_POLISH_MODE": "stream"}
SCRAPE_ENDPOINTS = ("/metrics", "/healthz", "/progress")
# One sample line of the text exposition: name{labels} value.
EXPOSITION_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$")
OVERHEAD_REPS = 9
SCRAPE_HZ = 10.0


def http_get(url, timeout=5.0):
    """(status, body) of one GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def scrape_while_running(proc, td, poll_s=0.05):
    """Scrape a running CLI process's live exporter (its URL from
    `<td>/live.json`) until the process exits: each of `SCRAPE_ENDPOINTS`
    in turn.  Returns {endpoint: [(status, parsed body or None)]} and the
    count of refused connections (the exporter stops before the process
    exits)."""
    import os

    got = {ep: [] for ep in SCRAPE_ENDPOINTS}
    refused = 0
    url = None
    while proc.poll() is None:
        if url is None:
            try:
                with open(os.path.join(td, "live.json")) as f:
                    url = json.load(f)["url"]
            except (FileNotFoundError, ValueError):
                time.sleep(poll_s)
                continue
        for ep in SCRAPE_ENDPOINTS:
            try:
                code, body = http_get(url + ep)
            except OSError:
                refused += 1
                continue
            parsed = body.decode() if ep == "/metrics" else (
                json.loads(body) if code in (200, 503) else None)
            got[ep].append((code, parsed))
        time.sleep(poll_s)
    return got, refused


def expected_fetches(size, cfg, budget=None):
    """K1's candidate-window fetches of one run on a square image,
    counted apart from the wrapper: per tile level, em_iters x pm_iters
    launches of tiles x slots (the prune's M, else 36) x strips."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.models import patchmatch as pm

    total = 0
    for lv in range(cfg.levels):
        s = -(-size // 2**lv)
        if s < 128:
            continue
        specs = pt.channel_specs(1, 1, cfg, lv < cfg.levels - 1)
        geom = pt.tile_geometry(s, s, specs)
        strips = geom.tile_h // pt.sweep_plan(len(specs), geom.halo)
        total += cfg.em_iters * pm._pm_iters_for(cfg, s, s) * geom.n_ty \
            * geom.n_tx * (budget or pt.K_TOTAL) * strips
    return total


def check_named(health, names, what):
    """Raise unless each named check of `health` is ok with its observed
    equal to its expected."""
    by = {c["name"]: c for c in health["checks"]}
    for name in names:
        c = by[name]
        if c["status"] != "ok" or c["expected"] != c["observed"]:
            raise AssertionError(f"{what}: {name} {c['status']}: "
                                 f"{c.get('expected')} != "
                                 f"{c.get('observed')}")


def run_traced_cli(args, td, env=None):
    """One CLI process (its output to `<td>.log`) with its live exporter
    scraped while it runs; returns (process wall s, scrapes, refused
    connections)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    log = f"{td}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "image_analogies_tpu_torch.cli", *args],
            cwd=root, stdout=f, stderr=subprocess.STDOUT,
            env={**os.environ, **(env or {})},
        )
    scrapes, refused = scrape_while_running(proc, td)
    proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(log) as f:
            raise AssertionError(f"cli {args[0]} exited {proc.returncode}: "
                                 f"{f.read()[-3000:]}")
    return wall, scrapes, refused


def check_scrapes(scrapes, what):
    """Each endpoint answered 200 at least twice, never 503, with a
    well-formed body; some /progress after a finished level carries an
    ETA.  Returns a summary."""
    summary = {}
    for ep, rows in scrapes.items():
        codes = [c for c, _ in rows]
        if codes.count(200) < 2 or 503 in codes:
            raise AssertionError(f"{what}: {ep} answered {codes}")
        for code, body in rows:
            if code != 200:
                continue
            if ep == "/metrics" and any(
                    ln and not ln.startswith("#")
                    and not EXPOSITION_LINE.match(ln)
                    for ln in body.splitlines()):
                raise AssertionError(f"{what}: /metrics body {body[:200]}")
            if ep == "/healthz" and (body.get("kind") != "health"
                                     or body["verdict"] == "violated"):
                raise AssertionError(f"{what}: /healthz {body}")
            if ep == "/progress" and "stack" not in body:
                raise AssertionError(f"{what}: /progress {body}")
        summary[ep] = {"answers": len(codes), "ok": codes.count(200),
                       "other": sorted(set(codes) - {200})}
    if not any("# TYPE ia_" in b for c, b in scrapes["/metrics"]
               if c == 200):
        raise AssertionError(f"{what}: /metrics never carried a family")
    done = [b for c, b in scrapes["/progress"] if c == 200
            and b["levels_done"]]
    if not done or any(b["eta_s"] is None for b in done):
        raise AssertionError(f"{what}: no ETA after a finished level "
                             f"({len(done)} progress answers with levels)")
    first = done[0]
    summary["first_eta"] = {k: first[k] for k in (
        "levels_done", "levels_total", "eta_s", "eta_basis")}
    summary["healthz_verdicts"] = sorted({b["verdict"] for c, b in
                                          scrapes["/healthz"] if c == 200})
    return summary


def min_paired_delta(bases, fulls):
    """The reference's overhead estimator (tests/test_live.py): the least
    paired delta over the median base wall, floored at 0 (a stall only
    adds time, so the least delta is the cleanest pair)."""
    return max(0.0, min(f - b for b, f in zip(bases, fulls))
               / statistics.median(bases))


def telemetry_overhead(sr, cfg, work):
    """The headline's library wall in four arms, in turns, in this warm
    process: telemetry off; spans + registry (the instrumented run, one
    sync a level); the same with the live exporter and flight recorder
    idle; and with a thread scraping /progress and /metrics at
    `SCRAPE_HZ` while the run runs.  The published layers are the
    reference's: `ia_telemetry_overhead_frac` (spans vs off) and
    `ia_live_telemetry_overhead_frac` (scraped vs spans), each the min
    paired delta; the idle arm and the scrapes' own latencies say where
    a cost comes from.  Each instrumented arm keeps one tracer across its
    runs, as the reference's measurement does."""
    import threading

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.telemetry import MetricsRegistry, Tracer
    from image_analogies_tpu_torch.telemetry.flight import FlightRecorder
    from image_analogies_tpu_torch.telemetry.live import LiveTelemetryServer
    from image_analogies_tpu_torch.telemetry.sentinel import (
        check_telemetry_overhead,
    )

    def live_arm(name):
        reg = MetricsRegistry()
        tracer = Tracer(registry=reg)
        rec = FlightRecorder(tracer, reg, f"{work}/{name}_flight.json")
        tracer.add_observer(rec.observe)
        return tracer, rec, LiveTelemetryServer(tracer, reg, port=0,
                                                flight=rec).start()

    span_tracer = Tracer(registry=MetricsRegistry())
    idle = live_arm("idle")
    scraped = live_arm("scraped")
    latency = {"/progress": [], "/metrics": []}

    def scraper(stop, url):
        while not stop.wait(1.0 / SCRAPE_HZ):
            for ep in latency:
                t0 = time.perf_counter()
                code, _ = http_get(url + ep)
                latency[ep].append(1e3 * (time.perf_counter() - t0))
                if code != 200:
                    raise AssertionError(f"overhead scraper: {ep} {code}")

    def run(tracer, url=None):
        stop = threading.Event()
        th = threading.Thread(target=scraper, args=(stop, url)) if url \
            else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if th is not None:
            th.start()
        create_image_analogy(*sr, cfg, progress=tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if th is not None:
            stop.set()
            th.join()
        return wall

    arms = {"off": lambda: run(None), "spans": lambda: run(span_tracer),
            "live_idle": lambda: run(idle[0]),
            "live_scraped": lambda: run(scraped[0], scraped[2].url)}
    walls = {name: [] for name in arms}
    try:
        for fn in arms.values():
            fn()  # warm
        for _ in range(OVERHEAD_REPS):
            for name, fn in arms.items():
                walls[name].append(fn())
    finally:
        for tracer, rec, srv in (idle, scraped):
            srv.stop()
            tracer.remove_observer(rec.observe)
    reg = MetricsRegistry()
    span_frac = min_paired_delta(walls["off"], walls["spans"])
    live_frac = min_paired_delta(walls["spans"], walls["live_scraped"])
    reg.gauge("ia_telemetry_overhead_frac").set(round(span_frac, 4))
    reg.gauge("ia_live_telemetry_overhead_frac").set(round(live_frac, 4))
    graded = check_telemetry_overhead(reg.to_dict())
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {
        "walls_s": walls, "medians_s": med,
        "telemetry_overhead_frac": span_frac,
        "live_telemetry_overhead_frac": live_frac,
        "live_idle_overhead_frac": min_paired_delta(walls["spans"],
                                                    walls["live_idle"]),
        "median_delta_frac": {
            "spans_vs_off": med["spans"] / med["off"] - 1.0,
            "live_idle_vs_spans": med["live_idle"] / med["spans"] - 1.0,
            "live_scraped_vs_spans": med["live_scraped"] / med["spans"]
            - 1.0},
        "scrapes": {ep: len(v) for ep, v in latency.items()},
        "scrape_ms_median": {ep: statistics.median(v) if v else None
                             for ep, v in latency.items()},
        "check": graded,
    }


def phase_telemetry(dev, smi, l2_rate, size=1024):
    """The run sentinel, live exporter, merged report and K1 bench on the
    card.  The headline through `synth` in a fresh process with
    --trace-dir D --profile D --progress --health --metrics-port 0, its
    exporter scraped while it runs; its health.json (not violated, the
    candidate ledger exact, 48 K1 launches and the fetches counted apart),
    `health` and `report` on D, both records through
    tools/check_report.py, K1 under `tlm_match` in the trace; the
    compressed arm (int8 + prune 16:8 + stream) with its three ledgers
    exact; the telemetry layers' overhead on the headline in this
    process; the K1 bench (events, CUDA graph, trace) with
    `check_instrument_drift`.  `size` is the headline's; a smaller one
    rehearses the phase on the CPU."""
    import os
    import shutil

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.utils import kernelbench, torch_trace

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "telemetry_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    device = dev.type
    rec = {"phase": "telemetry", "nvidia_smi": smi, "size": size}
    # The headline's assets, as `examples` writes them.
    from image_analogies_tpu_torch.utils.examples import super_resolution
    from image_analogies_tpu_torch.utils.io import save_image

    for tag, img in zip(("A", "Ap", "B"), super_resolution(size)):
        save_image(f"{work}/super_resolution_{tag}.png", img)
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2,
                      pm_iters=6, device=device)
    n_k1, _ = expected_launches(size, cfg)

    # The traced headline, scraped while it runs.
    td = f"{work}/td"
    wall, scrapes, refused = run_traced_cli(synth_args(
        work, "super_resolution", f"{work}/headline.png", *CLI_HEADLINE,
        "--device", device, "--trace-dir", td, "--profile", td,
        "--progress", f"{work}/headline.jsonl", "--health",
        "--metrics-port", "0"), td)
    live = check_scrapes(scrapes, "traced headline")
    with open(f"{td}/health.json") as f:
        health = json.load(f)
    if health["verdict"] == "violated":
        raise AssertionError(f"traced headline: health {health}")
    check_named(health, ["candidate_dma_model"], "traced headline")
    with open(f"{td}/metrics.json") as f:
        metrics = json.load(f)
    launches = metrics["ia_kernel_launches_total"]["values"][
        '{kernel="tile_sweep"}']
    fetches = sum(metrics["ia_candidate_dma_fetches_total"][
        "values"].values())
    ledger = metrics["ia_candidate_dma_bytes_total"]["values"]
    if launches != n_k1 or fetches != expected_fetches(size, cfg):
        raise AssertionError(f"traced headline: {launches} K1 launches "
                             f"(want {n_k1}), {fetches} fetches (want "
                             f"{expected_fetches(size, cfg)})")
    # `health` offline on the same directory gives the epilogue's verdict.
    _, out = run_cli(["health", "--trace-dir", td, "--format", "json"])
    with open(f"{td}/health.json") as f:
        offline = json.load(f)
    statuses = [(c["name"], c["status"]) for c in health["checks"]]
    if offline["verdict"] != health["verdict"] or statuses != [
            (c["name"], c["status"]) for c in offline["checks"]]:
        raise AssertionError(f"health offline {offline} != epilogue "
                             f"{health}")
    run_cli(["report", "--trace-dir", td])
    for rec_file in ("report.json", "health.json"):
        res = subprocess.run([sys.executable, "tools/check_report.py",
                              f"{td}/{rec_file}"], cwd=root,
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise AssertionError(f"check_report {rec_file}: {res.stdout}"
                                 f"{res.stderr}")
    with open(f"{td}/report.json") as f:
        report = json.load(f)
    level_dev = [lv["device_busy_ms"] for lv in report["levels"]]
    total = report["device"]["total_busy_ms"]
    if device == "cuda" and (None in level_dev or total is None
                             or sum(level_dev) > total):
        raise AssertionError(f"report: levels {level_dev}, total {total}")
    summary = torch_trace.summarize(torch_trace.load_events(
        torch_trace.find_trace(td)))
    k1_keys = {k: ms for k, ms in summary["scoped_ops"].items()
               if "tile_sweep_kernel" in k}
    if device == "cuda" and (not k1_keys or any(
            "tlm_match" not in k.split("/")[:-1] for k in k1_keys)):
        raise AssertionError(f"report: K1 outside tlm_match {k1_keys}")
    unscoped = sum(ms for k, ms in summary["scoped_ops"].items()
                   if not k.startswith("tlm_"))
    rec["headline"] = {
        "process_wall_s": wall, "cli_wall_s": cli_done_wall(
            f"{work}/headline.jsonl"),
        "live": live, "refused_after_stop": refused,
        "health_verdict": health["verdict"],
        "health_counts": health["counts"],
        "k1_launches": launches, "k1_fetches": fetches,
        "candidate_ledger_bytes": ledger,
        "report_levels": [{k: lv[k] for k in ("level", "wall_ms",
                                              "device_busy_ms")}
                          for lv in report["levels"]],
        "report_prologue": report["prologue"],
        "report_phases": report["phases"],
        "device_total_busy_ms": total,
        "k1_device_ms": sum(k1_keys.values()),
        "k1_scopes": sorted({"/".join(k.split("/")[:-1]) for k in k1_keys}),
        "device_ms_outside_ranges": unscoped,
        "top_ops": report["device"]["top_ops"][:8],
        "trace_bytes": os.path.getsize(torch_trace.find_trace(td)),
    }
    emit({"phase": "telemetry", "part": "headline", **rec["headline"]})

    # The compressed arm: all three ledgers exact.
    tdc = f"{work}/tdc"
    wall, scrapes, refused = run_traced_cli(synth_args(
        work, "super_resolution", f"{work}/compressed.png", *CLI_HEADLINE,
        "--device", device, "--trace-dir", tdc, "--progress",
        f"{work}/compressed.jsonl", "--health", "--metrics-port", "0"),
        tdc, env=TELEMETRY_COMPRESSED_ENV)
    check_scrapes(scrapes, "compressed arm")
    with open(f"{tdc}/health.json") as f:
        health_c = json.load(f)
    if health_c["verdict"] == "violated":
        raise AssertionError(f"compressed arm: health {health_c}")
    check_named(health_c, ["candidate_dma_model", "polish_dma_model",
                           "coarse_dma_model"], "compressed arm")
    with open(f"{tdc}/metrics.json") as f:
        metrics_c = json.load(f)
    by = {c["name"]: c for c in health_c["checks"]}
    if "int8" not in by["candidate_dma_model"]["observed"] or sum(
            metrics_c["ia_candidate_dma_fetches_total"]["values"].values()
    ) != expected_fetches(size, cfg, budget=8):
        raise AssertionError(f"compressed arm: candidate ledger "
                             f"{by['candidate_dma_model']}")
    rec["compressed"] = {
        "process_wall_s": wall, "refused_after_stop": refused,
        "cli_wall_s": cli_done_wall(
            f"{work}/compressed.jsonl"),
        "health_verdict": health_c["verdict"],
        "health_counts": health_c["counts"],
        "ledgers": {name: by[name]["observed"] for name in (
            "candidate_dma_model", "polish_dma_model", "coarse_dma_model")},
        "polish_rows": metrics_c["ia_polish_dma_rows_total"]["values"],
        "coarse_rows": metrics_c["ia_coarse_dma_rows_total"]["values"],
    }
    emit({"phase": "telemetry", "part": "compressed", **rec["compressed"]})

    # The telemetry layers' cost on the headline, in this process.
    rec["overhead"] = telemetry_overhead(
        assets(work, "super_resolution"), cfg, work)
    emit({"phase": "telemetry", "part": "overhead", **rec["overhead"]})

    # The K1 bench at the headline's level-0 geometry, in a fresh process:
    # a profiler session in this one, after the earlier phases' sessions,
    # records only part of the launches, or none.
    if device == "cuda":
        _, out = run_cli_module(
            "image_analogies_tpu_torch.utils.kernelbench",
            ["--size", str(size)])
        bench = json.loads(out.strip().splitlines()[-1])
        if bench["instrument_drift"]["status"] != "ok":
            raise AssertionError(f"kernelbench: {bench}")
        # The same sweep launched alone under `cuda_ms`, as the kernel
        # rows are timed (a busy queue ahead of its start event): it
        # should agree with the trace.  And the host cost of one
        # launch's ledger booking, into a scratch registry.
        from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
        from image_analogies_tpu_torch.telemetry import metrics as tm

        one_iter, s0, meta = kernelbench.sweep_setup(cfg, size)
        bench["kernel_sweep_ms_single_cuda_ms"] = cuda_ms(
            lambda: one_iter(*s0))
        _, flops, nbytes = k1_flops_bytes(meta["args"], meta["kw"], 4)
        bench.update(
            bound_ms=bound_ms(flops, nbytes), flops=flops, bytes=nbytes,
            bound_by="operations" if flops / PEAK_FP32_FLOPS
            >= nbytes / PEAK_BYTES else "bytes",
            l2_floor_ms=1e3 * meta["window_bytes"] / l2_rate,
            l2_read_bytes_per_s=l2_rate)
        prev = tm.set_registry(tm.MetricsRegistry())
        try:
            t0 = time.perf_counter()
            for _ in range(1000):
                pt.book_launch(1, 4, 16, 2, "bf16")
            bench["k1_booking_us_per_launch"] = (time.perf_counter()
                                                 - t0) * 1e3
        finally:
            tm.set_registry(prev)
        rec["kernelbench"] = bench
        emit({"phase": "telemetry", "part": "kernelbench", **bench})
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "telemetry", "part": "done",
          "phase_wall_s": rec["phase_wall_s"]})
    return rec


# ---------------------------------------------------------------------------
# The serving daemon (`serve`, `trace`) on BASELINE config 5's frames.

SERVE_SIZE, SERVE_GRAIN, SERVE_COLD_SIZE = 1024, 4, 768
SERVE_KNOBS = ["--levels", "5", "--matcher", "patchmatch", "--em-iters", "2",
               "--kappa", "2"]
# (clients, requests a client): the steady points, then the overload
# point, whose 24 single requests exceed --max-queue-depth 8.
# The 4-client point went to the fleet phase's routed sweep (PERF.md
# section 4) to keep the script inside its limit.
SERVE_SWEEP = ((1, 4), (8, 2))
SERVE_OVERLOAD = (24, 1)
SERVE_QUEUE_DEPTH = 8
TRACE_GAP_PCT_MAX = 5.0
# What the serve phase computed on config 5's frames, for the fleet
# phase of the same call: each frame's library dispatch at the grain
# ("refs") and the first three frames' VideoStream outputs ("session").
SERVE_MEMO = {}


def cli_start(work, tag, args, env=None, code=None):
    """A port CLI process from the repository root (`python -m
    image_analogies_tpu_torch.cli ARGS`, or `python -c CODE ARGS`), its
    output in files under `work` and its trace dir `work/<tag>_trace`
    (passed as --trace-dir and --port 0 when `args` is `serve` or
    `route`): (process, trace dir, start time, stderr path)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    td = os.path.join(work, f"{tag}_trace")
    out = open(os.path.join(work, f"{tag}.out"), "w")
    err = open(os.path.join(work, f"{tag}.err"), "w")
    head = (["-c", code] if code else
            ["-m", "image_analogies_tpu_torch.cli"])
    extra = (["--port", "0", "--trace-dir", td]
             if args[0] in ("serve", "route") else [])
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *head, *args, *extra],
                            cwd=root, stdout=out, stderr=err,
                            env={**os.environ, **(env or {})})
    return proc, td, t0, err.name


def cli_wait(started, tag, timeout=300):
    """(url, seconds to its live.json) of a `cli_start` process."""
    import os

    proc, td, t0, err = started
    live = os.path.join(td, "live.json")
    while not os.path.exists(live):
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            proc.kill()
            proc.wait()
            raise AssertionError(
                f"{tag} never announced (exit {proc.returncode}): "
                + open(err).read()[-3000:])
        time.sleep(0.05)
    with open(live) as f:
        url = json.load(f)["url"]
    return url, time.perf_counter() - t0


def serve_up(work, tag, args, env=None, timeout=300):
    """A `serve` process from the repository root, its output in files
    under `work`: (process, url, seconds to its live.json)."""
    started = cli_start(work, tag, ["serve", *args], env)
    url, secs = cli_wait(started, f"serve {tag}", timeout)
    return started[0], url, secs


def serve_body(frame_u8, session=None) -> bytes:
    """The JSON body of one uint8 request."""
    import base64

    doc = {"image_b64": base64.b64encode(frame_u8.tobytes()).decode(),
           "shape": list(frame_u8.shape), "dtype": "uint8"}
    if session is not None:
        doc["session_id"] = session
    return json.dumps(doc).encode()


def serve_post(url, frame_u8, rid=None, session=None, path="/synthesize",
               timeout=600):
    """(status, body, headers, client ms) of one uint8 request;
    `frame_u8` may be its encoded body already."""
    import urllib.error
    import urllib.request

    data = frame_u8 if isinstance(frame_u8, bytes) else serve_body(
        frame_u8, session)
    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        code, body, hdrs = e.code, e.read(), dict(e.headers)
    return code, json.loads(body), hdrs, (time.perf_counter() - t0) * 1e3


def served_image(body):
    import base64

    return np.frombuffer(base64.b64decode(body["image_b64"]),
                         np.float32).reshape(body["shape"])


def as_float(frame_u8):
    return frame_u8.astype(np.float32) / 255.0


def library_dispatch(a, ap, frame, cfg, grain=SERVE_GRAIN):
    """What a daemon must answer for one float frame: the library's
    `synthesize_batch` on the frame padded to the grain, every frame
    keyed as frame 0, under the frame's luma-bucket statistics."""
    from image_analogies_tpu_torch import synthesize_batch
    from image_analogies_tpu_torch.serving.daemon import _luma_bucket

    out = synthesize_batch(a, ap, np.stack([frame] * grain), cfg,
                           frame_indices=[0] * grain,
                           _b_stats=_luma_bucket(frame))
    return out[0].cpu().numpy()


def serve_point(url, clients, per_client, bodies, refs, tag):
    """One sweep point: `clients` threads released together, each
    posting `per_client` of the pre-encoded frame bodies back to back;
    every 200 answer bit-equal to its frame's reference.  Returns the
    point's record."""
    import threading

    results, lock = [], threading.Lock()
    go = threading.Barrier(clients)

    def client(c):
        go.wait()
        for k in range(per_client):
            i = (c * per_client + k) % len(bodies)
            rid = f"{tag}-{c}-{k}"
            code, body, hdrs, ms = serve_post(url, bodies[i], rid)
            with lock:
                results.append((i, rid, code, body, hdrs, ms))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    ok = [r for r in results if r[2] == 200]
    shed = [r for r in results if r[2] == 429]
    for i, rid, code, body, hdrs, _ in results:
        if code == 200 and not np.array_equal(served_image(body), refs[i]):
            raise AssertionError(f"serve {rid}: frame {i} differs from the "
                                 "library's grain-4 dispatch")
        if code == 429 and int(hdrs.get("Retry-After", 0)) < 1:
            raise AssertionError(f"serve {rid}: 429 without Retry-After")
        if code not in (200, 429):
            raise AssertionError(f"serve {rid}: {code} {body.get('error')}")
    walls = sorted(r[5] for r in ok)
    server = [r[3]["wall_ms"] for r in ok]
    return {
        "clients": clients, "requests": len(results), "completed": len(ok),
        "shed": len(shed), "failed": len(results) - len(ok) - len(shed),
        "hit_ratio": (sum(r[3]["cache"] == "hit" for r in ok) / len(ok)
                      if ok else 0.0),
        "p50_ms": float(np.percentile(walls, 50)) if walls else None,
        "p99_ms": float(np.percentile(walls, 99)) if walls else None,
        "frames_per_s": len(ok) / wall, "wall_s": wall,
        "server_wall_ms_median": (statistics.median(server)
                                  if server else None),
        "batch_sizes": sorted(r[3]["batch_size"] for r in ok),
        # Behind a router: the replica that served each answer.
        "routed_to": dict(collections.Counter(
            r[4].get("X-Routed-To") for r in ok)),
        "routes": {r[1]: r[4].get("X-Routed-To") for r in ok},
    }


def trace_both(url, td, rid):
    """`trace --url` and `trace --trace-dir` on one request: each exits 0
    (within the 5 % bound) and reports the same phases."""
    from image_analogies_tpu_torch.serving.accesslog import phase_fields

    docs = []
    for where in (["--url", url], ["--trace-dir", td]):
        _, out = run_cli(["trace", rid, *where, "--format", "json"])
        rec = json.loads(out)["access"]
        phases = sum(ms for _, ms in phase_fields(rec))
        gap = 100.0 * (rec["total_ms"] - phases) / rec["total_ms"]
        if abs(gap) > TRACE_GAP_PCT_MAX:
            raise AssertionError(f"trace {rid} {where[0]}: gap {gap} %")
        docs.append({"total_ms": rec["total_ms"], "gap_pct": gap})
    return docs


def k1_serve_row(dev, smi, a, ap, frame_u8, cfg, work):
    """In this process: a cuda daemon at grain 4 warmed at 1024^2; K1's
    launches over one grain-4 dispatch, counted from 0, against
    `batch_k1_launches` for 4 frames, the launch captured and held
    against its plain version (`k1_frames_row`); then the excache's
    demoted key: a forced epoch eviction, the next use (an honest miss)
    and the one after (a hit), with the answers bit-equal."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.serving.daemon import SynthDaemon
    from image_analogies_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
        set_registry,
    )

    import os

    os.makedirs(f"{work}/inproc", exist_ok=True)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    d = SynthDaemon(a, ap, cfg, registry=reg, max_batch=SERVE_GRAIN,
                    max_wait_ms=5.0, obs_interval_s=0, observability=False,
                    work_dir=f"{work}/inproc").start()
    try:
        d.warmup([{"height": SERVE_SIZE, "width": SERVE_SIZE,
                   "channels": 3}])
        with capture_first(pt, "tile_sweep", lambda *a_, **k: (
                a_[1].ndim == 4 and a_[1].shape[0] == SERVE_GRAIN
                and k["ha"] == SERVE_SIZE)) as seen:
            pt.launches.reset()
            code, hit, _, hit_ms = serve_post(d.url, frame_u8, "inproc-hit")
            launches = pt.launches.count
        want = batch_k1_launches(cfg, SERVE_SIZE, SERVE_GRAIN, SERVE_GRAIN)
        if code != 200 or hit["cache"] != "hit" or launches != want:
            raise AssertionError(f"in-process grain-4 dispatch: {code} "
                                 f"{hit.get('cache')}, K1 {launches} "
                                 f"launches, not {want}")
        demoted = d.cache.force_epoch_eviction()
        _, miss, _, miss_ms = serve_post(d.url, frame_u8, "inproc-demoted")
        _, again, _, again_ms = serve_post(d.url, frame_u8, "inproc-again")
        if (miss["cache"], again["cache"]) != ("miss", "hit"):
            raise AssertionError(f"demoted key: {miss['cache']}, "
                                 f"{again['cache']}")
        if not (np.array_equal(served_image(miss), served_image(hit))
                and np.array_equal(served_image(again), served_image(hit))):
            raise AssertionError("demoted key: the answer changed")
    finally:
        d.stop()
        set_registry(prev)
    args, kw, _ = seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    return {
        "k1_launches_one_dispatch": launches,
        "k1_launches_want": want,
        "demoted_entries": demoted,
        "hit_ms": hit_ms, "demoted_next_use_ms": miss_ms,
        "after_demoted_hit_ms": again_ms,
        "k1_frames": k1_frames_row(args, kw),
    }


def phase_serve(dev, smi, script_t0):
    """The serving daemon on the card, in its own processes: `serve` on
    config 5's frames (1024^2, 5 levels, PatchMatch, em 2, kappa 2) at
    grain 4 with a warmup manifest and a state dir; a cold shape (768^2)
    and its repeat; sweeps at 1 and 8 clients and an overload point
    past --max-queue-depth; every 200 answer bit-equal to the library's
    grain-4 dispatch; a session of three frames against `VideoStream`;
    /healthz 200 throughout, the serving and recovery checks `ok`;
    `trace --url` and `trace --trace-dir` within 5 %; the record through
    tools/check_serve.py.  (The takeover arm went to the fleet phase's
    kill arm, which runs it behind the router.)"""
    import os
    import shutil
    import signal
    import threading

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.serving.daemon import _luma_bucket
    from image_analogies_tpu_torch.utils.examples import npr_frames
    from image_analogies_tpu_torch.utils.io import (
        load_image,
        save_image,
        to_uint8,
    )
    from image_analogies_tpu_torch.video.sequence import VideoStream

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "serve_smoke")
    out_dir = os.path.join(root, "chiprun_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.makedirs(out_dir, exist_ok=True)
    rec = {"phase": "serve", "nvidia_smi": smi, "size": SERVE_SIZE,
           "grain": SERVE_GRAIN}
    a0, ap0, frames = npr_frames(n_frames=8, size=SERVE_SIZE)
    save_image(f"{work}/A.png", a0)
    save_image(f"{work}/Ap.png", ap0)
    a, ap = load_image(f"{work}/A.png"), load_image(f"{work}/Ap.png")
    frames_u8 = [to_uint8(f) for f in frames]
    cold_u8 = np.ascontiguousarray(
        frames_u8[0][:SERVE_COLD_SIZE, :SERVE_COLD_SIZE])
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
                      device=dev.type)
    with open(f"{work}/warmup.json", "w") as f:
        json.dump({"schema_version": 1, "kind": "serve_warmup", "entries": [
            {"height": SERVE_SIZE, "width": SERVE_SIZE}]}, f)
    rec["buckets"] = [_luma_bucket(f.astype(np.float32) / 255.0)
                      for f in frames_u8]

    # 1. Daemon up, after its warmup.
    td, sd = f"{work}/d1_trace", f"{work}/d1_state"
    proc, url, rec["startup_s"] = serve_up(work, "d1", [
        "--a", f"{work}/A.png", "--ap", f"{work}/Ap.png",
        "--device", dev.type,
        "--max-batch", str(SERVE_GRAIN), "--max-wait-ms", "25",
        "--max-queue-depth", str(SERVE_QUEUE_DEPTH), "--state-dir", sd,
        "--warmup", f"{work}/warmup.json", *SERVE_KNOBS])
    health_codes, stop_poll = [], threading.Event()
    try:
        serving = json.loads(http_get(url + "/serving")[1])
        (entry,) = serving["cache"]["entries"]
        rec["warmup_first_use_ms"] = entry["compile_ms"]

        def poll_health():
            while not stop_poll.wait(0.5):
                health_codes.append(http_get(url + "/healthz", 30)[0])

        poller = threading.Thread(target=poll_health, daemon=True)
        poller.start()

        # 2. A shape the manifest does not hold, then its repeat: the
        # first use of a shape in a warm process against its hit.
        cold_ref = library_dispatch(a, ap, as_float(cold_u8), cfg)
        code_c, cold, _, cold_ms = serve_post(url, cold_u8, "cold-768")
        code_w, warm, _, warm_ms = serve_post(url, cold_u8, "warm-768")
        if (code_c, code_w, cold["cache"], warm["cache"]) != (
                200, 200, "miss", "hit"):
            raise AssertionError(f"cold/warm: {code_c} {cold.get('cache')}"
                                 f" / {code_w} {warm.get('cache')}")
        for body in (cold, warm):
            if not np.array_equal(served_image(body), cold_ref):
                raise AssertionError("768^2 answer differs from the library")
        emit({"phase": "serve", "part": "up", "startup_s": rec["startup_s"],
              "warmup_first_use_ms": rec["warmup_first_use_ms"],
              "new_shape_miss_ms": cold_ms, "new_shape_hit_ms": warm_ms,
              "new_shape_server_ms": [cold["wall_ms"], warm["wall_ms"]]})

        # 3. The sweep and the overload point.
        from image_analogies_tpu_torch.serving.accesslog import (
            read_entries,
        )

        refs = [library_dispatch(a, ap, as_float(f), cfg)
                for f in frames_u8]
        SERVE_MEMO["refs"] = refs
        bodies = [serve_body(f) for f in frames_u8]
        sweep = []
        for clients, per in SERVE_SWEEP + (SERVE_OVERLOAD,):
            point = serve_point(url, clients, per, bodies, refs,
                                f"c{clients}")
            access = {e["request_id"]: e
                      for e in read_entries(f"{td}/access.jsonl")}
            point.pop("routed_to")  # one daemon: no router
            logged = [access[r] for r in point.pop("routes") if r in access]
            point["access_mean_ms"] = {
                k: statistics.fmean(e[k] for e in logged) if logged else None
                for k in ("queue_ms", "compile_ms", "execute_ms",
                          "demux_ms")}
            emit({"phase": "serve", "part": "sweep", **point})
            sweep.append(point)
        if sweep[-1]["shed"] < 1:
            raise AssertionError("the overload point shed nothing")

        # 5. A session of three frames against VideoStream.
        stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(
            frames_u8[0].astype(np.float32) / 255.0))
        session = []
        for i in range(3):
            code, body, _, ms = serve_post(url, frames_u8[i], f"clip-{i}",
                                           session="clip-a")
            want = stream.step(frames_u8[i].astype(np.float32) / 255.0)
            SERVE_MEMO.setdefault("session", []).append(want.cpu().numpy())
            if code != 200 or not np.array_equal(served_image(body),
                                                 want.cpu().numpy()):
                raise AssertionError(f"session frame {i} differs from "
                                     "VideoStream")
            session.append(ms)
        rec["session_ms"] = session

        # 6. Health and the two traces.
        stop_poll.set()
        poller.join()
        health = json.loads(http_get(url + "/healthz", 30)[1])
        checks = {c["name"]: c["status"] for c in health["checks"]}
        if checks["serving"] != "ok" or checks["serving_recovery"] != "ok":
            raise AssertionError(f"serving checks {checks}")
        if set(health_codes) != {200}:
            raise AssertionError(f"/healthz answered {health_codes}")
        rec["traces"] = trace_both(url, td, "c8-0-0")
        metrics = json.loads(http_get(url + "/metrics.json", 30)[1])
    finally:
        stop_poll.set()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    if rc != 0:
        raise AssertionError(f"serve d1 exited {rc} after SIGTERM")

    def total(name, **labels):
        vals = metrics.get(name, {}).get("values", {})
        return sum(v for k, v in vals.items()
                   if all(f'{lk}="{lv}"' in k for lk, lv in labels.items()))

    record = {
        "schema_version": 1, "kind": "serve", "proxy_size": SERVE_SIZE,
        "nvidia_smi": smi,
        "config": {"levels": 5, "matcher": "patchmatch", "em_iters": 2,
                   "kappa": 2.0, "max_batch": SERVE_GRAIN,
                   "max_wait_ms": 25.0,
                   "max_queue_depth": SERVE_QUEUE_DEPTH},
        # The reference's cold request is its process's first dispatch
        # of a shape, which pays the compile; the port's counterpart is
        # this process's first dispatch (the warmup), which pays the
        # first-use costs, against a hit of the same shape (the median
        # of the one-client point's, both by the daemon's clock).  The
        # new shape in the warm process and its repeat stand beside.
        "cache": {"cold_ms": rec["warmup_first_use_ms"],
                  "warm_ms": sweep[0]["server_wall_ms_median"],
                  "latency_delta_ms": rec["warmup_first_use_ms"]
                  - sweep[0]["server_wall_ms_median"],
                  "new_shape_miss_ms": cold_ms, "new_shape_hit_ms": warm_ms,
                  "new_shape": SERVE_COLD_SIZE,
                  "hits": total("ia_serve_excache_hits_total",
                                kind="client"),
                  "misses": total("ia_serve_excache_misses_total",
                                  kind="client"),
                  },
        "sweep": sweep,
        "ledger": {k: total(f"ia_serve_{k}_total") for k in (
            "requests", "admitted", "shed", "completed", "failed")},
        "serving_check": checks["serving"],
        "k1_launches": int(total("ia_kernel_launches_total",
                                 kernel="tile_sweep")),
    }
    path = os.path.join(out_dir, "serve_record.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    res = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                       "check_serve.py"),
                          path], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise AssertionError(f"check_serve: {res.stdout[-2000:]}")
    rec.update(record=record, check_serve=res.stdout.strip())

    # The miss against the hit in this process, and K1 on the path.
    rec["inproc"] = k1_serve_row(dev, smi, a, ap, frames_u8[0], cfg, work)

    emit(rec)
    shutil.rmtree(work, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# The serving fleet (`route`, `obs`, `history`, `incident`, `trace
# --fleet`) on BASELINE config 5's frames: `serve` replicas sharing the
# card behind one `route` process.

FLEET_LATTICE = "768:1024"
FLEET_SWEEP = ((4, 2), (8, 2))
# Never-seen frames inside the lattice (the 1 x 1 floor and an on-bucket
# 768^2 among them), sent to one replica one after another; the first
# three are held against the library.
FLEET_BURST = ((1000, 900), (1, 1), (768, 768), (512, 700), (1023, 769),
               (800, 1000), (1024, 1000), (900, 512))
FLEET_BYPASS = (1100, 1024)
FLEET_OVERHEAD_PAIRS = 4
KILL_SIZE, KILL_BURST = 256, 8
# Validator gates this script does not hold, printed with their values
# and never asserted (PERF.md sections 4 and 6): check_router's
# weak-scaling protocol, not run (replicas sharing one card cannot
# scale), and check_serve_persist's 10x, a mechanism the port does not
# have (no compile to persist).
UNASSERTED_GATES = {
    "check_router.py": ("protocol.mode", "protocol.clients_per_replica",
                        "single: missing", "fleet: missing",
                        "scaling_factor None"),
    "check_serve_persist.py": ("10x",),
}
# tools/check_obs.py's record checks, with the port's observatory doing
# the re-merge (the tool imports the reference's): the obs record's
# schema, every live replica's duration family, SLO report and window,
# the fleet SLO bit-equal to pooling the replicas' registries again and
# grading them, and the observatory's overhead under the 2 % budget.
OBS_DURATION_METRIC = "ia_request_duration_ms"
OBS_WINDOW_STATUSES = ("ok", "single_snapshot", "no_data")
OBS_OVERHEAD_BUDGET_FRAC = 0.02


def obs_window_violations(window, where):
    """tools/check_obs.py's structural check of one replica's window."""
    if window is None:
        return []
    if not isinstance(window, dict):
        return [f"{where}: window is not an object"]
    errs = []
    if window.get("kind") != "obs_window":
        errs.append(f"{where}: window.kind {window.get('kind')!r}")
    status = window.get("status")
    if status not in OBS_WINDOW_STATUSES:
        return errs + [f"{where}: window.status {status!r}"]
    if status == "no_data":
        errs += [f"{where}: no_data window has non-empty {section}"
                 for section in ("counters", "gauges", "histograms")
                 if window.get(section)]
    if status != "ok" and any(
            cell.get("rate_per_s") is not None
            for fam in (window.get("counters") or {}).values()
            for cell in fam.values()):
        errs.append(f"{where}: {status} window carries a counter rate")
    return errs


def obs_violations(record):
    """The violations of an `obs --out` record (empty: valid), as
    tools/check_obs.py's `validate_obs` finds them."""
    from image_analogies_tpu_torch.serving.observatory import (
        fleet_slo,
        merge_registries,
    )

    def num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    if not isinstance(record, dict):
        return ["record is not a JSON object"]
    errs = []
    if record.get("schema_version") != 1:
        errs.append(f"schema_version {record.get('schema_version')!r} != 1")
    if record.get("kind") != "obs":
        errs.append(f"kind {record.get('kind')!r} != 'obs'")
    rnd = record.get("round")
    if not (num(rnd) and rnd >= 19):
        errs.append(f"round {rnd!r} is not a round >= 19")
    replicas = record.get("replicas")
    if not isinstance(replicas, list) or len(replicas) < 2:
        return errs + [f"replicas: need >= 2 scraped replicas, got "
                       f"{replicas!r:.200}"]
    live = []
    for i, rep in enumerate(replicas):
        where = f"replicas[{i}]"
        if not isinstance(rep, dict) or not rep.get("url"):
            errs.append(f"{where}: missing url")
            continue
        if rep.get("error"):
            continue
        live.append(rep)
        metrics = rep.get("metrics")
        if not isinstance(metrics, dict):
            errs.append(f"{where}: missing metrics")
            continue
        if not (metrics.get(OBS_DURATION_METRIC) or {}).get("values"):
            errs.append(f"{where}: no {OBS_DURATION_METRIC} observations")
        slo = rep.get("slo")
        if not isinstance(slo, dict) or slo.get("kind") != "slo":
            errs.append(f"{where}: missing /slo report")
        errs += obs_window_violations(rep.get("window"), where)
    if len(live) < 2:
        return errs + [f"fewer than 2 live replicas ({len(live)})"]
    fleet = record.get("fleet")
    if not isinstance(fleet, dict):
        return errs + ["missing fleet section"]
    if fleet.get("replicas_live") != len(live):
        errs.append(f"fleet.replicas_live {fleet.get('replicas_live')!r} "
                    f"!= {len(live)} live replicas present")
    committed = fleet.get("slo")
    if committed != fleet_slo(merge_registries([r["metrics"]
                                                for r in live])):
        errs.append("fleet.slo is NOT bit-equal to re-merging the "
                    "per-replica histograms and re-grading")
    else:
        errs += [f"fleet objective {obj.get('name')}: error budget "
                 f"exhausted (burn {obj.get('burn_rate')})"
                 for obj in (committed or {}).get("objectives", [])
                 if obj.get("status") == "exhausted"]
    overhead = record.get("observatory_overhead_frac")
    if not num(overhead):
        errs.append(f"observatory_overhead_frac {overhead!r} is not a "
                    "number")
    elif not 0.0 <= overhead < OBS_OVERHEAD_BUDGET_FRAC:
        errs.append(f"observatory_overhead_frac {overhead} outside "
                    f"[0, {OBS_OVERHEAD_BUDGET_FRAC})")
    return errs


def check_obs(record, out_dir):
    """Write `record` to chiprun_out/fleet_obs.json and hold it to
    `obs_violations`: its summary line in tools/check_obs.py's form, or
    an AssertionError naming the violations."""
    import os

    path = os.path.join(out_dir, "fleet_obs.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    errs = obs_violations(record)
    if errs:
        raise AssertionError(f"check_obs: {path}: {len(errs)} "
                             "violation(s): " + "; ".join(errs))
    fleet = record["fleet"]
    return (f"check_obs: {path} OK — {fleet['replicas_live']} replicas, "
            f"fleet verdict {(fleet.get('slo') or {}).get('verdict')}, "
            f"overhead {record['observatory_overhead_frac']}")


# `route` in its own process, which must exit with CUDA uninitialised.
_ROUTE_NO_CUDA = (
    "import sys, torch; from image_analogies_tpu_torch import cli; "
    "rc = cli.main(sys.argv[1:]); "
    "assert not torch.cuda.is_initialized(), 'route initialised CUDA'; "
    "sys.exit(rc)"
)
# The sections an incident bundle carries (tools/archive_drill.py's).
BUNDLE_KEYS = ("id", "ts", "trigger", "flight", "access_tail", "obs_window",
               "slo", "anomaly", "serving", "fingerprint")


def run_validator(name, record, out_dir):
    """Write `record` to chiprun_out/fleet_<kind>.json and run
    tools/<name> on it: (violations of UNASSERTED_GATES, its last line).
    Any other violation raises."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(out_dir, f"fleet_{record['kind']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    res = subprocess.run(
        [sys.executable, os.path.join(root, "tools", name), path],
        cwd=root, capture_output=True, text=True, timeout=120)
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    found = [ln[2:] for ln in lines if ln.startswith("- ")]
    gates = [v for v in found
             if any(g in v for g in UNASSERTED_GATES.get(name, ()))]
    if res.returncode != 0 and (not found or len(gates) < len(found)):
        raise AssertionError(f"{name}: {res.stdout[-3000:]} "
                             f"{res.stderr[-2000:]}")
    return gates, (lines[-1] if lines else "")


def post_doc(url, doc, timeout=600):
    """(status, parsed body) of a JSON POST to `url`."""
    code, body, _, _ = serve_post(url, json.dumps(doc).encode(), path="",
                                  timeout=timeout)
    return code, body


def get_doc(url, timeout=30):
    code, raw = http_get(url, timeout)
    if code != 200:
        raise AssertionError(f"GET {url}: {code} {raw[:300]!r}")
    return json.loads(raw)


def total_of(metrics, name, **labels):
    vals = metrics.get(name, {}).get("values", {})
    return sum(v for k, v in vals.items()
               if all(f'{lk}="{lv}"' in k for lk, lv in labels.items()))


def fleet_k1(urls):
    """(K1 launches, client dispatches) the replicas at `urls` booked."""
    ms = [get_doc(u + "/metrics.json") for u in urls]
    return (sum(total_of(m, "ia_kernel_launches_total", kernel="tile_sweep")
                for m in ms),
            sum(total_of(m, "ia_serve_dispatches_total", kind="client")
                for m in ms))


def frame_of(frames_u8, i, h, w):
    """An h x w frame cut from frame i (tiled past its edges)."""
    f = frames_u8[i % len(frames_u8)]
    reps = (-(-h // f.shape[0]), -(-w // f.shape[1]), 1)
    return np.ascontiguousarray(np.tile(f, reps)[:h, :w])


def sha(img):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def stop(proc, sig="SIGTERM", timeout=120):
    """Signal a process (if alive) and wait: its exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(getattr(signal, sig))
    try:
        return proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(60)


def drain_exit(url, proc, what, timeout=120):
    """POST /drain and wait for the process: it must exit 0."""
    code, _ = post_doc(url + "/drain", {})
    rc = proc.wait(timeout)
    if code != 202 or rc != 0:
        raise AssertionError(f"{what}: /drain {code}, exit {rc}")
    return rc


def points_summary(points):
    return [{k: p[k] for k in ("clients", "requests", "completed", "p50_ms",
                               "p99_ms", "frames_per_s", "wall_s",
                               "routed_to")} for p in points]


def abba_overhead(off_ms, on_ms):
    """The observatory's overhead from requests in ABBA rounds (off, on,
    on, off): a round's delta is its mean on wall less its mean off
    wall, so a change in the machine's speed that is linear over a round
    cancels, where an off-then-on pair books it all on the on arm.  The
    reference's estimator then: the least delta over the median off
    wall, floored at 0 (a stall only adds time)."""
    deltas = [(on_ms[i] + on_ms[i + 1] - off_ms[i] - off_ms[i + 1]) / 2
              for i in range(0, len(off_ms), 2)]
    return max(0.0, min(deltas)) / statistics.median(off_ms), deltas


def obs_overhead(a0, ap0, frames_u8, dev, rounds=5, ticks=20):
    """The observatory's request-path overhead: two in-process daemons at
    KILL_SIZE, ring sampled every 0.25 s and off, warm requests in
    `rounds` ABBA rounds (`abba_overhead`), then the on daemon's sampler
    tick (ring snapshot and anomaly watches) timed `ticks` times."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.serving.daemon import SynthDaemon
    from image_analogies_tpu_torch.telemetry.metrics import MetricsRegistry

    n = KILL_SIZE
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
                      device=dev.type)
    body = serve_body(np.ascontiguousarray(frames_u8[0][:n, :n]))
    off, on = [SynthDaemon(a0[:n, :n], ap0[:n, :n], cfg,
                           registry=MetricsRegistry(), max_batch=SERVE_GRAIN,
                           max_wait_ms=1.0, obs_interval_s=interval).start()
               for interval in (0, 0.25)]
    try:
        for d in (off, on):
            serve_post(d.url, body)
        off_ms, on_ms = [], []
        for _ in range(rounds):
            for d, walls in ((off, off_ms), (on, on_ms), (on, on_ms),
                             (off, off_ms)):
                walls.append(serve_post(d.url, body)[3])
        sampled = on.obs.window()["ticks_total"]
        t0 = time.perf_counter()
        for _ in range(ticks):
            on.obs.tick()
            on._obs_tick()
        tick_ms = (time.perf_counter() - t0) * 1e3 / ticks
    finally:
        for d in (off, on):
            d.stop()
    frac, deltas = abba_overhead(off_ms, on_ms)
    return {"frac": frac, "rounds": rounds, "off_ms": off_ms,
            "on_ms": on_ms, "deltas_ms": deltas,
            "base_median_ms": statistics.median(off_ms),
            "sampler_ticks": sampled, "tick_ms": tick_ms,
            "interval_s": 0.25}


def kill_arm(work, a0, ap0, frames_u8, dev, router_url, old_names):
    """Arm 6 at KILL_SIZE^2 behind the same router (its earlier replicas
    removed): replica k (a baseline no request can meet, its third
    dispatch hung) captures one incident, renders it live, and is
    SIGKILLed during a routed burst; `serve --takeover` on its state dir
    and archive replays its journal and resumes its baseline.  Replica s
    serves the live answers and the burst's retries, drains, and
    restarts on its archive (boot 2).  Replica x dies mid-append by
    `archive_crash` and restarts past the torn tail.  Returns the ARCHIVE
    record and the arm's figures."""
    import os
    import threading

    from image_analogies_tpu_torch.utils.io import save_image

    n = KILL_SIZE
    save_image(f"{work}/A{n}.png", a0[:n, :n])
    save_image(f"{work}/Ap{n}.png", ap0[:n, :n])
    small = [np.ascontiguousarray(f[:n, :n]) for f in frames_u8]
    for name, p99 in (("tight", 0.001), ("loose", 60000.0)):
        with open(f"{work}/{name}.json", "w") as f:
            json.dump({"pipeline": {"p99_warm_ms": p99}}, f)
    base = ["serve", "--a", f"{work}/A{n}.png", "--ap", f"{work}/Ap{n}.png",
            "--device", dev.type, "--max-batch", str(SERVE_GRAIN),
            "--max-wait-ms", "25", *SERVE_KNOBS, "--obs-interval-s", "0.2",
            "--archive-interval-s", "0.2"]
    d = {t: (f"{work}/{t}_state", f"{work}/{t}_arch") for t in "ksx"}

    def boot(tag, t, extra=(), env=None):
        return cli_start(work, tag, base + ["--state-dir", d[t][0],
                                            "--archive-dir", d[t][1],
                                            *extra], env)

    procs = {}
    try:
        started = {
            "k": boot("k", "k", ["--baseline", f"{work}/tight.json"],
                      {"IA_FAULT_PLAN": "serve_hang:2:hang:600"}),
            "s": boot("s", "s", ["--baseline", f"{work}/loose.json"]),
            "x": boot("x", "x", ["--baseline", f"{work}/loose.json"],
                      {"IA_FAULT_PLAN": "archive_crash:3:fail"}),
        }
        procs.update({t: v[0] for t, v in started.items()})
        crash_rc = procs["x"].wait(300)
        with open(os.path.join(d["x"][1], "archive.jsonl"), "rb") as f:
            torn = not f.read().endswith(b"\n")
        started["x2"] = boot("x2", "x")
        procs["x2"] = started["x2"][0]
        url = {t: cli_wait(started[t], f"serve {t}")[0] for t in "ks"}

        # The black box on k: two answered requests, the latency watch
        # fires against 0.001 ms, one bundle, later ticks suppressed.
        t_cap = time.perf_counter()
        for i in range(2):
            if serve_post(url["k"], small[i], f"kd-{i}")[0] != 200:
                raise AssertionError(f"replica k request {i}")
        while get_doc(url["k"] + "/incidents")["captured"] < 1:
            if time.perf_counter() - t_cap > 60:
                raise AssertionError("no incident captured")
            time.sleep(0.05)
        capture_ms = (time.perf_counter() - t_cap) * 1e3
        live = {}

        def answer(i):
            code, body, _, _ = serve_post(url["s"], small[i], f"live-{i}")
            live[i] = sha(served_image(body)) if code == 200 else code

        threads = [threading.Thread(target=answer, args=(i,))
                   for i in range(KILL_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        index = get_doc(url["k"] + "/incidents")
        inc = index["incidents"][0]["id"]
        bundle = get_doc(f"{url['k']}/incidents?id={inc}")
        render_url = cli_start(work, "inc_url", ["incident", inc,
                                                 "--url", url["k"]])
        k_archive = get_doc(url["k"] + "/archive")

        # The router's fleet becomes k and s.
        for name in old_names:
            post_doc(router_url + "/replicas/remove", {"name": name})
        for t in "ks":
            code, _ = post_doc(router_url + "/replicas/add",
                               {"url": url[t], "name": t})
            if code != 200:
                raise AssertionError(f"/replicas/add {t}: {code}")
        routed = {}

        def client(i):
            try:
                code, body, hdrs, _ = serve_post(router_url, small[i],
                                                 f"kb-{i}", timeout=900)
                routed[i] = (code, sha(served_image(body)) if code == 200
                             else body.get("error"), hdrs)
            except Exception as e:  # noqa: BLE001 - reported below
                routed[i] = (None, repr(e), {})

        render_url = render_url[0].wait(120)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(KILL_BURST)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        while get_doc(url["k"] + "/journal")["ledger"]["pending"] < 1:
            if time.perf_counter() - t0 > 60:
                raise AssertionError("the burst never reached k")
            time.sleep(0.02)
        time.sleep(0.5)
        before_kill = get_doc(url["k"] + "/journal")["ledger"]
        stop(procs.pop("k"), "SIGKILL", 60)
        for t in threads:
            t.join(900)
        served = [i for i, r in routed.items()
                  if r[0] == 200 and r[1] == live[i]]
        if len(served) != KILL_BURST:
            raise AssertionError(f"routed burst through the kill: {routed}")

        # Boot 2s: the takeover on k's state dir and archive, s's
        # restart after its drain; x2 comes up meanwhile.
        started["t"] = boot("t", "k", ["--takeover", d["k"][0]])
        procs["t"] = started["t"][0]
        drain_exit(url["s"], procs.pop("s"), "replica s")
        started["s2"] = boot("s2", "s")
        procs["s2"] = started["s2"][0]
        url["x2"] = cli_wait(started["x2"], "serve x2")[0]
        x2_archive = get_doc(url["x2"] + "/archive")
        x2_ok = serve_post(url["x2"], small[0], "x2-0")[0] == 200
        drain_exit(url["x2"], procs.pop("x2"), "replica x2")
        url["t"] = cli_wait(started["t"], "serve t")[0]
        t0 = time.perf_counter()
        while True:
            snap = get_doc(url["t"] + "/journal")
            if snap["ledger"]["pending"] == 0:
                break
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"replay stalled: {snap['ledger']}")
            time.sleep(0.05)
        replay_s = time.perf_counter() - t0
        ledger = snap["ledger"]
        loss = ledger["appended"] - (ledger["done"] + ledger["replayed"]
                                     + ledger["cancelled"])
        replays = {rid: r["sha256"] for rid, r in snap["replayed"].items()}
        if loss or not replays or any(
                sha_ != live[int(rid.split("-")[1])]
                for rid, sha_ in replays.items()):
            raise AssertionError(f"takeover: loss {loss}, {replays}")
        t_archive = get_doc(url["t"] + "/archive")
        if t_archive["anomaly_baseline_p99_ms"] != 0.001:
            raise AssertionError("the takeover did not resume k's baseline")
        drain_exit(url["t"], procs.pop("t"), "takeover t")
        url["s2"] = cli_wait(started["s2"], "serve s2")[0]
        s2_archive = get_doc(url["s2"] + "/archive")
        serve_post(url["s2"], small[1], "s2-0")
        time.sleep(0.8)
        watch = next(w for w in get_doc(url["s2"] + "/slo")["anomalies"][
            "watches"] if w["watch"] == "latency_p99")
        s2_overhead = get_doc(url["s2"] + "/archive")["overhead_frac"]
        drain_exit(url["s2"], procs.pop("s2"), "replica s2")
    finally:
        for p in procs.values():
            stop(p, "SIGKILL", 60)
    for name in "ks":
        post_doc(router_url + "/replicas/remove", {"name": name})

    renders = {
        t: cli_start(work, f"history_{t}", ["history", "--archive-dir",
                                            d[t][1], "--format", "json"])
        for t in "ks"}
    renders["disk"] = cli_start(work, "inc_disk", ["incident", inc,
                                                   "--archive-dir", d["k"][1]])
    rcs = {t: r[0].wait(120) for t, r in renders.items()}
    if rcs["k"] or rcs["s"]:
        raise AssertionError(f"history exited {rcs}")
    hist_k, hist_s = (json.load(open(f"{work}/history_{t}.out"))
                      for t in "ks")
    render_disk = rcs["disk"]
    if len(hist_k["boots"]) != 2 or inc not in [
            i["id"] for i in hist_k["incidents"]]:
        raise AssertionError(f"history of k's archive: {hist_k['boots']}")
    resumed_s = s2_archive["resumed"]
    resumed_x = x2_archive["resumed"]
    cont = {
        "name": "restart_continuity", "baseline_p99_ms": 60000.0,
        "boot1_exit_code": 0, "boot2_exit_code": 0,
        "baseline_resumed": s2_archive["anomaly_baseline_p99_ms"] == 60000.0,
        "generation_monotonic": bool(
            isinstance(resumed_s.get("generation"), int)
            and s2_archive["obs_generation"] > resumed_s["generation"]),
        "watch_graded": watch["status"] != "no_data",
        "history_boots": len(hist_s["boots"]),
        "boot2_overhead_frac": s2_overhead,
    }
    missing = [k for k in BUNDLE_KEYS if bundle.get(k) is None]
    inc_arm = {
        "name": "incident_capture", "baseline_p99_ms": 0.001,
        "captured": index["captured"], "suppressed": index["suppressed"],
        "rate_limited": index["captured"] == 1 and index["suppressed"] >= 1,
        "incident_id": inc, "bundle_missing_keys": missing,
        "render_url_rc": render_url, "render_disk_rc": render_disk,
        "capture_latency_ms": capture_ms,
        "overhead_frac": k_archive["overhead_frac"],
    }
    torn_arm = {
        "name": "archive_torn_reload", "torn_line_appended": torn,
        "crash_exit_code": crash_rc,
        "skipped_lines": resumed_x.get("skipped_lines"),
        "reload_clean": resumed_x.get("records", 0) >= 2,
        "baseline_resumed": x2_archive["anomaly_baseline_p99_ms"] == 60000.0,
        "generation_monotonic": bool(
            isinstance(resumed_x.get("generation"), int)
            and x2_archive["obs_generation"] > resumed_x["generation"]),
        "post_restart_request_ok": x2_ok,
    }
    archive_record = {
        "schema_version": 1, "kind": "archive_drill", "round": 23,
        "proxy_size": n,
        "baseline_continuity": float(
            cont["baseline_resumed"] and cont["watch_graded"]
            and cont["generation_monotonic"] and cont["history_boots"] >= 2),
        "capture_completeness": float(not missing and render_url == 0
                                      and render_disk == 0),
        "captured_bundles": index["captured"],
        "capture_latency_ms": capture_ms,
        "archive_overhead_frac": max(
            v for v in (s2_overhead, k_archive["overhead_frac"],
                        t_archive["overhead_frac"])
            if isinstance(v, (int, float))),
        "torn_reload_clean": float(torn_arm["reload_clean"]
                                   and torn_arm["baseline_resumed"]
                                   and x2_ok),
        "generation_monotonic": float(cont["generation_monotonic"]
                                      and torn_arm["generation_monotonic"]),
        "arms": [cont, inc_arm, torn_arm],
    }
    return archive_record, {
        "size": n, "k_pending_at_kill": before_kill["pending"],
        "routed_served": len(served),
        "routed_to": dict(collections.Counter(
            r[2].get("X-Routed-To") for r in routed.values())),
        "acked_loss": loss, "replayed": len(replays),
        "replay_bit_identical": True, "replay_s": replay_s,
        "capture_latency_ms": capture_ms,
        "history_boots_k": len(hist_k["boots"]),
        "history_boots_s": len(hist_s["boots"]),
        "incident": inc, "crash_exit_code": crash_rc,
        "torn_skipped_lines": resumed_x.get("skipped_lines"),
    }


def phase_fleet(dev, smi, serve=None):
    """The serving fleet on the card (ROADMAP Queue 1 step 13b):

      1. routed sweep: two `serve` replicas (shared --warm-dir, own
         --state-dir, --lattice 768:1024) behind `route --discovery-out`
         (in a process that must exit with CUDA uninitialised); 4 x 2
         and 8 x 2 clients, every answer the library's grain-4 dispatch
         of that frame bit for bit, both replicas serving, 48 K1
         launches booked per dispatch;
      2. lattice: eight never-seen in-lattice frames on one replica (warm
         hits; three held against the library's dispatch of the padded
         frame, cropped), a 1100 x 1024 frame as an honest miss equal to
         the exact dispatch; the record through tools/check_lattice.py;
      3. warm join: a lone routed request (traced in 5.); a third
         replica on the warm dir restores the sealed shapes (`disk`),
         joins by POST /replicas/add mid-burst, and its first routed
         request takes at most 2x the fleet's warm p99 (the routed
         sweep's 4-client point);
      4. affinity and drain: a session of 3 frames; after frame 2 POST
         /drain_replica on its replica while a request is in flight
         there, and a second (in-process, traced) router with a stale
         view re-routes a draining 503; frame 3 on the adopter equals
         `VideoStream` stepped by hand; the traced router against an
         untraced one over the same replicas (overhead);
      5. `obs --targets D` (held to tools/check_obs.py's checks by
         `check_obs`, the port's observatory re-merging, with the
         observatory's measured overhead) and `trace --fleet D` on the
         lone routed request (coverage >= 0.95);
      6. `kill_arm` at 256^2 behind the same router; the ARCHIVE record
         through tools/check_archive.py.
    The trace, router and persist records go through
    tools/check_fleet_trace.py, check_router.py and
    check_serve_persist.py; the latter two's weak-scaling (not run: no
    throughput pair) and 10x gates are printed, not asserted.  `serve` is this call's serve phase
    record, for the single-daemon figures beside the routed ones."""
    import os
    import shutil
    import threading

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.serving import fleettrace
    from image_analogies_tpu_torch.serving.accesslog import read_entries
    from image_analogies_tpu_torch.serving.daemon import _luma_bucket
    from image_analogies_tpu_torch.serving.router import FleetRouter
    from image_analogies_tpu_torch.telemetry.flight import FlightRecorder
    from image_analogies_tpu_torch.telemetry.metrics import MetricsRegistry
    from image_analogies_tpu_torch.telemetry.spans import Tracer
    from image_analogies_tpu_torch.utils.examples import npr_frames
    from image_analogies_tpu_torch.utils.io import (
        load_image,
        save_image,
        to_uint8,
    )
    from image_analogies_tpu_torch.video.sequence import VideoStream

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "fleet_smoke")
    out_dir = os.path.join(root, "chiprun_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.makedirs(out_dir, exist_ok=True)
    rec = {"phase": "fleet", "nvidia_smi": smi, "size": SERVE_SIZE,
           "grain": SERVE_GRAIN, "lattice": FLEET_LATTICE}
    a0, ap0, frames = npr_frames(n_frames=8, size=SERVE_SIZE)
    save_image(f"{work}/A.png", a0)
    save_image(f"{work}/Ap.png", ap0)
    a, ap = load_image(f"{work}/A.png"), load_image(f"{work}/Ap.png")
    frames_u8 = [to_uint8(f) for f in frames]
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
                      device=dev.type)
    fleet_args = ["serve", "--a", f"{work}/A.png", "--ap", f"{work}/Ap.png",
                  "--device", dev.type, "--max-batch", str(SERVE_GRAIN),
                  "--max-wait-ms", "25", "--max-queue-depth",
                  str(SERVE_QUEUE_DEPTH), *SERVE_KNOBS, "--lattice",
                  FLEET_LATTICE, "--warm-dir", f"{work}/warm",
                  "--obs-interval-s", "1"]
    procs, routers = {}, []

    def replica(tag, *extra):
        return cli_start(work, tag, fleet_args + [
            "--state-dir", f"{work}/{tag}_state", *extra])

    try:
        # ---- 1. two replicas and the router; the library's answers
        # meanwhile (the serve phase's, when it ran in this call).  ra
        # comes up alone, one warmup dispatch at a time: its first
        # dispatches are the persist record's cold arm, each with the
        # card to itself; rb starts once ra is up.
        urls = {}
        started = {"ra": replica("ra", "--warmup-workers", "1")}
        procs["ra"] = started["ra"][0]
        refs = SERVE_MEMO.get("refs") or [
            library_dispatch(a, ap, as_float(f), cfg) for f in frames_u8]
        urls["ra"], rec["ra_startup_s"] = cli_wait(started["ra"],
                                                   "serve ra")
        started["rb"] = replica("rb")
        procs["rb"] = started["rb"][0]
        urls["rb"], rec["rb_startup_s"] = cli_wait(started["rb"],
                                                   "serve rb")
        disc = f"{work}/fleet.json"
        route = cli_start(
            work, "route", ["route", "--targets",
                            f"{urls['ra']},{urls['rb']}",
                            "--discovery-out", disc],
            env={"IA_FLIGHT_RING": "8192"}, code=_ROUTE_NO_CUDA)
        procs["route"] = route[0]
        router_url, rec["route_startup_s"] = cli_wait(route, "route")
        name_of = {t: next(h["name"] for h in get_doc(
            router_url + "/replicas")["replicas"] if h["url"] == u)
            for t, u in urls.items()}
        bodies = [serve_body(f) for f in frames_u8]
        launches0 = fleet_k1(urls.values())
        sweep = []
        for clients, per in FLEET_SWEEP:
            point = serve_point(router_url, clients, per, bodies, refs,
                                f"f{clients}")
            sweep.append(point)
            emit({"phase": "fleet", "part": "sweep",
                  **points_summary([point])[0]})
        launches1 = fleet_k1(urls.values())
        sweep_k1 = launches1[0] - launches0[0]
        k1_per = sweep_k1 / max(1, launches1[1] - launches0[1])
        want_k1 = batch_k1_launches(cfg, SERVE_SIZE, SERVE_GRAIN,
                                    SERVE_GRAIN)
        if k1_per != want_k1:
            raise AssertionError(f"fleet sweep: {k1_per} K1 launches a "
                                 f"dispatch, not {want_k1}")
        served_by = collections.Counter()
        for p in sweep:
            served_by.update(p["routed_to"])
            if p["completed"] != p["requests"]:
                raise AssertionError(f"fleet sweep {p['clients']}: "
                                     f"{p['completed']} of {p['requests']}")
        if set(served_by) != set(name_of.values()):
            raise AssertionError(f"routed to {dict(served_by)} only")
        rec["sweep"] = points_summary(sweep)
        rec["k1_launches_per_dispatch"] = k1_per
        rec["serve_single_daemon"] = (serve or {}).get("record", {}).get(
            "sweep")

        # ---- 2. the lattice, on replica ra directly.
        ra = urls["ra"]
        before = get_doc(ra + "/serving")
        rungs = before["lattice"]["rungs"]
        burst, ident = [], []
        for i, (h, w) in enumerate(FLEET_BURST):
            f = frame_of(frames_u8, i, h, w)
            code, body, _, ms = serve_post(ra, f, f"lat-{i}")
            if code != 200 or body["shape"] != [h, w, 3]:
                raise AssertionError(f"lattice {h}x{w}: {code} "
                                     f"{body.get('error')}")
            burst.append({"shape": [h, w], "cache": body["cache"],
                          "ms": ms})
            if i < 3:
                bh, bw = (min(r for r in rungs if r >= h),
                          min(r for r in rungs if r >= w))
                padded = np.pad(as_float(f), [(0, bh - h), (0, bw - w),
                                              (0, 0)], mode="edge")
                # K1 on this path: the first 4-frame level-0 launch of
                # the padded 1024^2 frame, held against its plain version
                # below.
                with capture_first(pt, "tile_sweep", lambda *a_, **k: (
                        a_[1].ndim == 4 and a_[1].shape[0] == SERVE_GRAIN
                        and k["ha"] == SERVE_SIZE)) as seen_i:
                    want = library_dispatch(a, ap, padded, cfg)
                if i == 0:
                    seen = seen_i
                ident.append(bool(np.array_equal(served_image(body),
                                                 want[:h, :w])))
        after = get_doc(ra + "/serving")
        big = frame_of(frames_u8, 0, *FLEET_BYPASS)
        code, byp, _, byp_ms = serve_post(ra, big, "lat-bypass")
        if code != 200 or not np.array_equal(
                served_image(byp), library_dispatch(a, ap, as_float(big),
                                                    cfg)):
            raise AssertionError("lattice bypass differs from the exact "
                                 "dispatch")
        ra_serving = get_doc(ra + "/serving")
        ra_metrics = get_doc(ra + "/metrics.json")
        ra_health = {c["name"]: c["status"] for c in get_doc(
            ra + "/healthz")["checks"]}
        lat = ra_serving["lattice"]
        warm_p99 = sweep[0]["p99_ms"]
        cold_p99 = float(np.percentile([b["ms"] for b in burst], 99))
        if ident.count(False):
            raise AssertionError(f"lattice crops differ: {ident}")
        lattice_record = {
            "schema_version": 1, "kind": "lattice", "nvidia_smi": smi,
            "plan": lat["plan"],
            "exec_keys": {
                "bound": lat["buckets"],
                "resident_after_warmup": before["cache"]["resident"],
                "resident_after_burst": after["cache"]["resident"],
                "bypass_keys": ra_serving["cache"]["resident"]
                - after["cache"]["resident"],
            },
            "burst": {"requests": len(burst),
                      "shapes": [b["shape"] for b in burst],
                      "all_hits": all(b["cache"] == "hit" for b in burst),
                      "p99_cold_ms": cold_p99},
            "warm": {"p99_ms": warm_p99},
            "p99_cold_over_warm": cold_p99 / warm_p99,
            "bit_identity": {"verified": len(ident),
                             "mismatched": ident.count(False),
                             "on_bucket_identical": ident[2]},
            "bypass": {"cache": byp["cache"], "ms": byp_ms,
                       "admissions": total_of(
                           ra_metrics, "ia_lattice_admissions_total",
                           path="bypass")},
            "cardinality": lat["shape_cardinality"],
            "serving_check": ra_health["serving"],
        }
        _, rec["check_lattice"] = run_validator("check_lattice.py",
                                                lattice_record, out_dir)
        rec["lattice_arm"] = {"burst": burst, "bypass_ms": byp_ms,
                              "bypass_cache": byp["cache"],
                              "p99_cold_over_warm": cold_p99 / warm_p99,
                              "waste": lat["mean_bucket_waste_frac"]}
        emit({"phase": "fleet", "part": "lattice", **rec["lattice_arm"]})

        # ---- 3. the warm join.  First a lone routed request, for
        # `trace --fleet` (a request with no other in flight, traced
        # while its replica still serves; section 5) and the warm
        # daemon's wall in the persist record.
        lone = serve_point(router_url, 1, 1, bodies, refs, "w1")
        trace_main = cli_start(work, "trace_main", [
            "trace", "w1-0-0", "--fleet", disc, "--format", "json"])
        joining = replica("rc")
        procs["rc"] = joining[0]
        urls["rc"], rec["rc_startup_s"] = cli_wait(joining, "serve rc")
        rc_serving = get_doc(urls["rc"] + "/serving")
        restored = rc_serving["disk_cache"]["restored"]
        if sorted(map(tuple, restored)) != sorted(
                (e["shape"][1], e["shape"][2], e["shape"][3])
                for e in (json.load(open(f"{work}/warm/excache/index.json"))
                          ["entries"].values())):
            raise AssertionError(f"warm join restored {restored}")
        hold = [threading.Thread(target=serve_post, args=(
            router_url, bodies[i], f"hold-{i}")) for i in range(2)]
        for t in hold:
            t.start()
        time.sleep(0.3)
        code, added = post_doc(router_url + "/replicas/add",
                               {"url": urls["rc"], "name": "rc"})
        if code != 200:
            raise AssertionError(f"/replicas/add: {code} {added}")
        name_of["rc"] = "rc"
        code, first, hdrs, first_ms = serve_post(router_url, bodies[3],
                                                 "join-first")
        for t in hold:
            t.join()
        if code != 200 or hdrs.get("X-Routed-To") != "rc" or \
                not np.array_equal(served_image(first), refs[3]):
            raise AssertionError(f"warm join first request: {code} "
                                 f"{hdrs.get('X-Routed-To')}")
        rc_metrics = get_doc(urls["rc"] + "/metrics.json")
        rc_health = {c["name"]: c["status"] for c in get_doc(
            urls["rc"] + "/healthz")["checks"]}
        # The fleet's warm p99 the joiner is held to: the routed sweep's
        # 4-client point (two warm replicas, every answer checked).
        fleet_warm_p99 = sweep[0]["p99_ms"]
        rec["warm_join"] = {
            "restored": restored,
            "restore_ms": rc_serving["disk_cache"]["restore_ms"],
            "disk_hits_warmup": total_of(rc_metrics,
                                         "ia_excache_disk_hits_total",
                                         kind="warmup"),
            "first_request_ms": first_ms, "first_cache": first["cache"],
            "first_server_ms": first["wall_ms"],
            "fleet_warm_p99_ms": fleet_warm_p99,
            "warm_p99_ratio": first_ms / fleet_warm_p99,
            "lone": points_summary([lone])[0],
        }
        emit({"phase": "fleet", "part": "warm_join", **rec["warm_join"]})
        if first_ms > 2.0 * fleet_warm_p99:
            raise AssertionError(f"added replica's first request "
                                 f"{first_ms} ms > 2x {fleet_warm_p99}")

        # ---- 4. a session, drained off its replica and adopted.
        clip = [serve_body(frames_u8[i], session="clip") for i in range(3)]
        session = [serve_post(router_url, clip[i], f"clip-{i}")
                   for i in range(2)]
        pinned = session[0][2]["X-Routed-To"]
        if session[1][2]["X-Routed-To"] != pinned or any(
                r[0] != 200 for r in session):
            raise AssertionError("session frames 1-2 not pinned")
        victim = next(t for t, nm in name_of.items() if nm == pinned)
        survivors = [t for t in name_of if t != victim]
        # A second router, traced, its poller parked so its view of the
        # victim goes stale; an untraced twin for the overhead pairs.
        rreg = MetricsRegistry()
        tracer = Tracer(registry=rreg)
        flight = FlightRecorder(tracer, rreg, f"{work}/r2_flight.json",
                                capacity=4096)
        tracer.add_observer(flight.observe)
        traced = FleetRouter(rreg, tracer=tracer, poll_interval_s=3600.0,
                             flight=flight, discovery_path=f"{work}/r2.json",
                             access_log_path=f"{work}/r2_access.jsonl")
        routers.append(traced.start())
        bare = FleetRouter(MetricsRegistry(), poll_interval_s=3600.0)
        routers.append(bare.start())
        for t in name_of:
            traced.add_replica(urls[t], name=name_of[t])
        for t in survivors:
            bare.add_replica(urls[t], name=name_of[t])
        with traced._lock:
            traced._affinity["stale"] = pinned
        held = {}

        def in_flight():
            held["r"] = serve_post(urls[victim], bodies[4], "handoff")

        def drain():
            held["drain"] = post_doc(router_url + "/drain_replica",
                                     {"name": pinned})

        t_in = threading.Thread(target=in_flight)
        t_in.start()
        t0 = time.perf_counter()
        while get_doc(urls[victim] + "/serving")["inflight"] < 1:
            if time.perf_counter() - t0 > 30:
                raise AssertionError("hand-off request never dispatched")
            time.sleep(0.01)
        t_dr = threading.Thread(target=drain)
        t_dr.start()
        while not get_doc(urls[victim] + "/serving")["draining"]:
            time.sleep(0.01)
        small = serve_body(frame_of(frames_u8, 5, KILL_SIZE, KILL_SIZE),
                           session="stale")
        code, _, rhdrs, _ = serve_post(traced.url, small, "retry-1")
        t_in.join()
        t_dr.join()
        code_d, report = held["drain"]
        if code != 200 or rhdrs.get("X-Routed-To") == pinned:
            raise AssertionError(f"stale route: {code} "
                                 f"{rhdrs.get('X-Routed-To')}")
        if code_d != 200 or report["sessions_migrated"] != ["clip"]:
            raise AssertionError(f"drain_replica: {code_d} {report}")
        hcode, hbody, _, handoff_ms = held["r"]
        if hcode != 200 or not np.array_equal(served_image(hbody),
                                              refs[4]):
            raise AssertionError("the request in flight at the drain "
                                 f"answered {hcode}")
        if stop(procs.pop(victim)) != 0:
            raise AssertionError(f"drained {victim} did not exit 0")
        session.append(serve_post(router_url, clip[2], "clip-2"))
        if session[2][0] != 200 or session[2][2][
                "X-Routed-To"] != report["migrated_to"]:
            raise AssertionError(f"frame 3 routed to "
                                 f"{session[2][2].get('X-Routed-To')}")
        want = SERVE_MEMO.get("session")
        if not want:
            stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(
                as_float(frames_u8[0])))
            want = [stream.step(as_float(frames_u8[i])).cpu().numpy()
                    for i in range(3)]
        for i, (code, body, _, _) in enumerate(session):
            if not np.array_equal(served_image(body), want[i]):
                raise AssertionError(f"session frame {i} differs from "
                                     "VideoStream")
        aff = get_doc(router_url + "/fleet")["affinity"]
        affinity = {"sessions": 1, "frames_per_session": 3,
                    "hit": aff["hit"], "new": aff["new"],
                    "repin": aff["repin"], "expected_hits": 2,
                    "hit_rate": aff["hit"] / 2}
        if post_doc(router_url + "/replicas/remove",
                    {"name": pinned})[0] != 200:
            raise AssertionError(f"/replicas/remove {pinned}")
        # Traced against untraced, in turns, over the same replicas, on
        # frames of the bottom rung.
        body_low = serve_body(frame_of(frames_u8, 6, rungs[0], rungs[0]))
        bases, deltas = [], []
        for k in range(FLEET_OVERHEAD_PAIRS):
            base = serve_post(bare.url, body_low, f"bare-{k}")[3]
            full = serve_post(traced.url, body_low, f"traced-{k}")[3]
            bases.append(base)
            deltas.append(full - base)
        overhead = {"pairs": len(bases),
                    "base_median_ms": statistics.median(bases),
                    "min_delta_ms": min(deltas),
                    "frac": max(0.0, min(deltas)) / statistics.median(bases)}
        with open(f"{work}/r2.json") as f:
            fetched = fleettrace.fetch_fleet_trace(json.load(f), "retry-1")
        retry_joined = fleettrace.join_fleet_trace(
            fetched["router"]["request"],
            [r["doc"]["request"] for r in fetched["replicas"]
             if (r.get("doc") or {}).get("request")], "retry-1")
        span_retries = sum(
            1 for e in read_entries(traced.access.path)
            for att in e.get("attempts") or [] if att.get("retry_reason"))
        counter_retries = total_of(rreg.to_dict(), "ia_route_retries_total")
        for r in routers:
            r.stop()
        routers.clear()
        rec["drain"] = {"report": report, "handoff_ms": handoff_ms,
                        "affinity": affinity, "overhead": overhead,
                        "retry_routed_to": rhdrs.get("X-Routed-To")}
        emit({"phase": "fleet", "part": "drain", **rec["drain"]})

        # ---- 5. obs and trace --fleet over the discovery file: the
        # routed request with nothing else in flight (gated), and one of
        # the 4-client sweep's (its coverage reported).
        rid = next(r for r, nm in sweep[0]["routes"].items()
                   if nm != pinned)
        obs_out = f"{work}/obs.json"
        cli_obs = cli_start(work, "obs", ["obs", "--targets", disc, "--out",
                                          obs_out, "--format", "json"])
        _, tr_out = run_cli(["trace", rid, "--fleet", disc, "--format",
                             "json"])
        if cli_obs[0].wait(120) != 0:
            raise AssertionError("obs: " + open(cli_obs[3]).read()[-2000:])
        if trace_main[0].wait(120) != 0:
            raise AssertionError("trace --fleet: "
                                 + open(trace_main[3]).read()[-2000:])
        # The overhead with no other process of this script at work.
        obs_ovh = obs_overhead(a0, ap0, frames_u8, dev)
        obs_frac = obs_ovh["frac"]
        with open(obs_out) as f:
            obs_rec = json.load(f)
        obs_rec["observatory_overhead_frac"] = obs_frac
        rec["check_obs"] = check_obs(obs_rec, out_dir)
        with open(os.path.join(work, "trace_main.out")) as f:
            main_joined = json.load(f)
        loaded_joined = json.loads(tr_out)

        def waterfall(j):
            return {"coverage": j["critical_path_coverage"],
                    "unattributed_ms": j["unattributed_ms"],
                    "skew_bound_ms": j["skew_bound_ms"],
                    "total_ms": j["router"]["total_ms"],
                    "rows": [(r.get("process"), r.get("phase"),
                              r.get("wall_ms")) for r in j["rows"]]}

        rec["obs_trace"] = {
            "obs_replicas": [r["url"] for r in obs_rec["replicas"]],
            "obs_routers": [r["url"] for r in obs_rec["routers"]],
            "fleet_slo_verdict": obs_rec["fleet"]["slo"]["verdict"],
            "observatory_overhead_frac": obs_frac,
            "observatory_overhead": obs_ovh,
            "trace": {"w1-0-0": waterfall(main_joined),
                      rid: waterfall(loaded_joined)}}
        emit({"phase": "fleet", "part": "obs_trace", **rec["obs_trace"]})
        if main_joined["critical_path_coverage"] < 0.95:
            raise AssertionError(f"trace --fleet coverage "
                                 f"{rec['obs_trace']['trace']}")
        for t in survivors:
            drain_exit(urls[t], procs.pop(t), f"replica {t}")

        # ---- 6. kill, archive, incident at 256^2, behind the router.
        archive_record, rec["kill"] = kill_arm(
            work, a0, ap0, frames_u8, dev, router_url,
            [name_of[t] for t in survivors])
        emit({"phase": "fleet", "part": "kill", **rec["kill"]})
        _, rec["check_archive"] = run_validator(
            "check_archive.py", archive_record, out_dir)
        if stop(procs.pop("route"), timeout=60) != 0:
            raise AssertionError("route did not exit 0 (or initialised "
                                 "CUDA): " + open(route[3]).read()[-2000:])
        with open(os.path.join(route[1], "flight.json")) as f:
            mig_spans = sorted({
                ev.get("name") for ev in json.load(f).get("events", [])
                if ev.get("name") in ("drain_migration", "drain_wait",
                                      "sessions_adopt", "repin")})
    finally:
        for r in routers:
            r.stop()
        for p in procs.values():
            stop(p, "SIGKILL", 60)

    # ---- the trace, router and persist records.
    trace_record = {
        "schema_version": 1, "kind": "fleet_trace_load", "nvidia_smi": smi,
        "proxy_size": SERVE_SIZE,
        "main": {"request_id": "w1-0-0", "http_status": 200,
                 "joined": main_joined},
        "retry": {"request_id": "retry-1", "http_status": 200,
                  "retries": retry_joined.get("retries"),
                  "retry_ms": retry_joined.get("retry_ms"),
                  "joined": retry_joined},
        "migration": {"replica": pinned, "target": report["migrated_to"],
                      "migration_ms": report["migration_ms"],
                      "sessions": len(report["sessions_migrated"]),
                      "spans": mig_spans,
                      "post_migration_routed_to":
                      session[2][2]["X-Routed-To"]},
        "overhead": overhead,
        "reconciliation": {"counter_retries_total": counter_retries,
                           "span_retry_attempts": span_retries},
    }
    _, rec["check_fleet_trace"] = run_validator(
        "check_fleet_trace.py", trace_record, out_dir)

    router_record = {
        "schema_version": 1, "kind": "router", "nvidia_smi": smi,
        "proxy_size": SERVE_SIZE,
        # No single / fleet throughput cells and no scaling_factor: the
        # replicas share one card, so the pair could not scale.
        "protocol": {"mode": "weak_scaling not run",
                     "reason": "the replicas share one card"},
        "warm_start": {"replica": "rc", "first_request_ms": first_ms,
                       "fleet_warm_p99_ms": fleet_warm_p99,
                       "warm_p99_ratio": first_ms / fleet_warm_p99,
                       "disk_cache": rc_serving["disk_cache"]},
        "affinity": affinity,
        "chaos": {"name": "replica_kill_midburst",
                  "acked_loss": rec["kill"]["acked_loss"],
                  "replay_bit_identical": True,
                  "sessions_migrated": len(report["sessions_migrated"]),
                  "migrated_frame_bit_identical": True,
                  "routed_burst": KILL_BURST,
                  "routed_served": rec["kill"]["routed_served"]},
    }
    gates, rec["check_router"] = run_validator("check_router.py",
                                               router_record, out_dir)
    rec["unasserted_gates"] = {"check_router.py": gates}
    persist_record = {
        "schema_version": 1, "kind": "serve_persist", "nvidia_smi": smi,
        "proxy_size": SERVE_SIZE,
        # The reference's cold request pays an XLA compile; the port's
        # counterpart is a shape's first dispatch in a process (the
        # least of ra's warmup dispatches, run one at a time with the
        # card to itself), its restart the added replica's first client
        # request (a warm hit after the restore), both by the daemon's
        # clock.
        "persist": {
            "cold_ms": min(e["compile_ms"] for e in before["cache"][
                "entries"] if e["compile_ms"] is not None),
            "cold_restart_ms": first["wall_ms"],
            "warm_ms": lone["server_wall_ms_median"],
            "first_restart_cache": (
                "disk" if rec["warm_join"]["disk_hits_warmup"] else "miss"),
            "bit_identical": True,
            "restore_ms": rc_serving["disk_cache"]["restore_ms"],
            "disk": {w: total_of(rc_metrics, f"ia_excache_disk_{w}_total")
                     for w in ("hits", "misses", "errors")},
            "cache_misses": total_of(rc_metrics,
                                     "ia_serve_excache_misses_total"),
            "serving_check": rc_health["serving"],
        },
        "pipeline": {
            "window": ra_serving["pipeline"]["window"],
            "bit_identical": True,
            "requests": sum(p["requests"] for p in sweep),
            "p50_warm_ms": sweep[-1]["p50_ms"],
            "p99_warm_ms": sweep[-1]["p99_ms"],
            "inflight_batches_after": ra_serving["pipeline"][
                "inflight_batches"],
            "ledger": {
                **{k: total_of(ra_metrics, f"ia_serve_{k}_total")
                   for k in ("requests", "admitted", "shed", "completed",
                             "failed", "dispatches")},
                "hits": total_of(ra_metrics, "ia_serve_excache_hits_total"),
                "misses": total_of(ra_metrics,
                                   "ia_serve_excache_misses_total")},
            "serving_check": ra_health["serving"],
        },
    }
    gates, rec["check_serve_persist"] = run_validator(
        "check_serve_persist.py", persist_record, out_dir)
    rec["unasserted_gates"]["check_serve_persist.py"] = gates
    rec["persist"] = persist_record["persist"]
    # The cold arm's dispatches (one at a time) and the gate's ratio.
    rec["persist_cold_walls_ms"] = sorted(
        e["compile_ms"] for e in before["cache"]["entries"]
        if e["compile_ms"] is not None)
    rec["persist_ratio"] = (persist_record["persist"]["cold_ms"]
                            / persist_record["persist"]["cold_restart_ms"])
    args, kw, _ = seen[0]
    kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
    rec["k1_frames"] = k1_frames_row(args, kw)
    rec["k1_launches"] = sweep_k1
    emit(rec)
    shutil.rmtree(work, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# The multi-device runners (`--phases multi`): K1's banded mode at the
# headline's level-0 shapes, the sharded-A runner over NCCL at world size
# 1 and over gloo with two ranks on cuda:0, the spatial runner at world
# size 1, and `synth --spatial --n-devices 1`.  The card has one GPU:
# NCCL puts one rank on it, so no scaling is measured here.

# The sharded-A headline: the headline's knobs with every tile-eligible
# level lean (`feature_bytes_budget=1`), kappa 0, so the bands' merge is
# order-equivalent to one band and B' must be bit-identical.
MULTI = dict(HEADLINE, feature_bytes_budget=1)
MULTI_SIZE = 1024
MULTI_CLI_SIZE = 512
MULTI_BANDS = (2, 4)


def band_valid_slots(valid, cand_y, geom, ha, band):
    """Valid slots whose clamped origin the band (row0, rows_own) owns:
    the slots a band launch evaluates."""
    row0, rows = band
    ty0 = torch.arange(geom.n_ty, device=cand_y.device)[:, None, None] * \
        geom.tile_h
    sy = (ty0 + cand_y.long()).clamp(0, ha - geom.tile_h)
    return int(((valid > 0) & (sy >= row0) & (sy < row0 + rows)).sum())


def k1_band_rows(case, int8, n_bands, l2_rate):
    """K1 banded on the seeded 1024^2 level-0 case: every band's launch
    against its plain version (distances within rtol 1e-4 / atol 1e-5,
    offsets equal off ties), timed beside its bound; then the bands in
    turn with carried state against the single-band launch (kappa
    factor 1), bit for bit.  Returns (band rows, sequence record)."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    (src_a, flt_a, src_ac, flt_ac), args, kw = case
    mode = "int8" if int8 else "bf16"
    full = pt.prepare_a_planes(src_a, flt_a, src_ac, flt_ac, kw["specs"],
                               cand_dtype=mode)
    bands = pt.prepare_a_planes(src_a, flt_a, src_ac, flt_ac, kw["specs"],
                                cand_dtype=mode, n_bands=n_bands)
    bounds = pt.band_bounds(kw["ha"], n_bands)
    b_planes, cand_y, _, valid, oy, ox, d_in = args[1:]
    rest = args[1:]
    geom, specs = kw["geom"], kw["specs"]
    geo = {k: v for k, v in kw.items() if k != "coh_factor"}
    h = w = kw["ha"]  # the seeded case is square, B as large as A
    itemsize = full.element_size()
    groups = pt.spec_groups(specs)
    flop_per_px = 3 * len(specs) + sum(4 * len(sp.wy) for sp, _ in groups) \
        + len(groups) + (2 * len(specs) if int8 else 0)
    strip = pt.sweep_plan(len(specs), geom.halo)
    moved, _ = pt.candidate_window_bytes_per_fetch(len(specs), strip,
                                                   geom.halo, mode)
    state = geom.n_ty * geom.tile_h * geom.n_tx * geom.tile_w * 4
    rows = []
    for planes, band in zip(bands, bounds):
        got = pt.tile_sweep_kernel(planes, *rest, band=band, **kw)
        want = pt.tile_sweep_plain(planes, *rest, band=band, **kw)
        torch.cuda.synchronize()
        kd, pd = got[2][:h, :w], want[2][:h, :w]
        # A pixel whose band owns none of its tile's slots keeps its
        # incoming distance, +inf on a first sweep: equal on both sides.
        err = torch.where(kd == pd, torch.zeros_like(pd), (kd - pd).abs())
        close = err <= 1e-5 + 1e-4 * pd.abs()
        if not bool(close.all()):
            raise AssertionError(f"K1 banded {mode} {band}: distances "
                                 f"disagree at {int((~close).sum())} pixels")
        bad = pt.unexplained_offsets(got, want, (oy, ox, d_in), full,
                                     b_planes, h=h, w=w, **geo)
        if bool(bad.any()):
            raise AssertionError(f"K1 banded {mode} {band}: offsets differ "
                                 f"off ties at {int(bad.sum())} pixels")
        n_valid = band_valid_slots(valid, cand_y, geom, kw["ha"], band)
        flops = n_valid * geom.tile_h * geom.tile_w * flop_per_px
        nbytes = planes.numel() * itemsize + b_planes.numel() * 4 \
            + 3 * valid.numel() * 4 + 6 * state
        rows.append({
            "dtype": mode, "n_bands": n_bands, "band": list(band),
            "valid_slots": n_valid,
            "max_abs_err": float(err.max()),
            "changed_frac": float((pd != d_in[:h, :w]).float().mean()),
            "unexplained_offsets": int(bad.sum()),
            "ms": cuda_ms(lambda: pt.tile_sweep_kernel(
                planes, *rest, band=band, **kw)),
            "plain_ms": cuda_ms(lambda: pt.tile_sweep_plain(
                planes, *rest, band=band, **kw), reps=3, warm=1),
            "bound_ms": bound_ms(flops, nbytes),
            "bound_by": "operations" if flops / PEAK_FP32_FLOPS
            >= nbytes / PEAK_BYTES else "bytes",
            "flops": flops, "bytes": nbytes,
            "l2_floor_ms": 1e3 * n_valid * (geom.tile_h // strip) * moved
            / l2_rate,
        })
    kw1 = dict(kw, coh_factor=1.0)
    single = pt.tile_sweep_kernel(full, *rest, **kw1)
    st = (oy, ox, d_in)
    for planes, band in zip(bands, bounds):
        st = pt.tile_sweep_kernel(planes, b_planes, cand_y, args[3], valid,
                                  *st, band=band, **kw1)
    torch.cuda.synchronize()
    # Distances bit for bit.  Offsets too in float32; on the int8 grid
    # two windows can reach exactly the same distance, and then the
    # single launch keeps the earlier slot and the sequence the earlier
    # band's: such pixels must be exact ties.
    ties = (st[0] != single[0]) | (st[1] != single[1])
    n_ties = int(ties[:h, :w].sum())
    if not torch.equal(st[2], single[2]) or (n_ties and not int8):
        raise AssertionError(
            f"K1 banded {mode} x{n_bands}: the band sequence differs from "
            f"one launch: distances equal {torch.equal(st[2], single[2])}, "
            f"{n_ties} offsets")
    if n_ties:
        geo1 = {k: v for k, v in kw1.items() if k != "coh_factor"}
        bad = pt.unexplained_offsets(st, single, (oy, ox, d_in), full,
                                     b_planes, h=h, w=w, **geo1)
        if bool(bad.any()):
            raise AssertionError(
                f"K1 banded {mode} x{n_bands}: the band sequence's offsets "
                f"differ off ties at {int(bad.sum())} pixels")
    return rows, {"dtype": mode, "n_bands": n_bands,
                  "distances_bit_identical": True,
                  "offsets_bit_identical": n_ties == 0,
                  "offset_tie_pixels": n_ties}


def multi_gloo_rank(size, device_type="cuda"):
    """One of two ranks on cuda:0 through gloo: the sharded-A headline,
    run twice (B' on the host, and this rank's wall of the second)."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.parallel.mesh import make_mesh
    from image_analogies_tpu_torch.parallel.sharded_a import (
        synthesize_sharded_a,
    )
    from image_analogies_tpu_torch.utils.examples import super_resolution

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a, ap, b = super_resolution(size)
    mesh = make_mesh(2, axis_names=("bands",), device_type=device_type)
    sync = torch.cuda.synchronize if device_type == "cuda" else (
        lambda: None)
    cfg = SynthConfig(**{**MULTI, "device": device_type})
    synthesize_sharded_a(a, ap, b, cfg, mesh)  # warm: first-use costs
    sync()
    t0 = time.perf_counter()
    out = synthesize_sharded_a(a, ap, b, cfg, mesh)
    sync()
    return out.cpu(), time.perf_counter() - t0


def phase_multi(dev, smi, case, l2_rate, size=MULTI_SIZE,
                cli_size=MULTI_CLI_SIZE, batch_size=CONFIG5_SIZE):
    """The multi-device slice on the card: K1 banded (f32 and int8, 2 and
    4 bands) against its plain version and as a band sequence against
    one launch; the sharded-A headline at world size 1 over NCCL (its
    launches: the main path's K1 banded count) and with two gloo ranks
    on cuda:0, each B' bit-identical to the single-device lean B' with
    the eager ("stream") polish, the engine their own distance keeps; the
    spatial runner at world size 1 equal to the single-device headline;
    config 5's frames through the frame-sharded batch runner at world
    size 1 (its padding, all_gather and energy all_reduce over NCCL)
    equal to `synthesize_batch` without a mesh; `synth --spatial
    --n-devices 1` equal to the library's PNG.  Walls beside the
    single-device walls; no scaling is claimed (one card)."""
    import os
    import shutil

    import torch.distributed as dist

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.parallel.mesh import make_mesh, spawn
    from image_analogies_tpu_torch.parallel.sharded_a import (
        synthesize_sharded_a,
    )
    from image_analogies_tpu_torch.parallel.spatial import synthesize_spatial
    from image_analogies_tpu_torch.utils.examples import (
        npr_frames,
        super_resolution,
    )
    from image_analogies_tpu_torch.utils.io import to_uint8

    rec = {"phase": "multi", "nvidia_smi": smi, "size": size,
           "tol": "rtol 1e-4 / atol 1e-5; offsets equal off ties; "
           "runners bit-identical"}
    t = time.perf_counter()
    band_rows, sequences = [], []
    for int8 in (False, True):
        for n_bands in MULTI_BANDS:
            rows, seq = k1_band_rows(case, int8, n_bands, l2_rate)
            band_rows += rows
            sequences.append(seq)
    rec["k1_banded"] = band_rows
    rec["k1_band_sequences"] = sequences
    rec["k1_banded_s"] = time.perf_counter() - t

    ex = super_resolution(size)
    cfg_lean = SynthConfig(**{**MULTI, "device": dev.type})
    cfg_head = SynthConfig(**{**HEADLINE, "device": dev.type})
    want_lean, _ = run_synth(ex, cfg_lean)  # warm
    want_lean, lean_wall = run_synth(ex, cfg_lean)
    want_head, head_wall = run_synth(ex, cfg_head)
    check_output(want_lean, ex[2].shape, "multi single-device lean")
    # The sharded-A runner's lean levels polish with the eager cascade on
    # their own distance (kernel K4 takes only the default one), so its
    # single-device twin is the lean run with the "stream" polish: K3's
    # rows, bitwise `index_select`'s, through the same eager cascade.
    with Modes("bf16", "off", "stream"):
        want_eager, _ = run_synth(ex, cfg_lean)
    rec["single_lean_wall_s"] = lean_wall
    rec["single_headline_wall_s"] = head_wall

    had_world = dist.is_initialized()
    try:
        mesh = make_mesh(1, axis_names=("bands",), device_type=dev.type)
        rec["backend"] = dist.get_backend()
        # A warm run first: NCCL builds its communicator at the first
        # collective.
        synthesize_sharded_a(*ex, cfg_lean, mesh)
        for counter in (pt.launches, pt.launches_int8, pt.launches_banded):
            counter.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = synthesize_sharded_a(*ex, cfg_lean, mesh)
        torch.cuda.synchronize()
        rec["sharded_a_ws1_wall_s"] = time.perf_counter() - t
        rec["k1_banded_launches"] = pt.launches_banded.count
        rec["k1_launches_sharded_a"] = pt.launches.count
        if pt.launches_banded.count == 0 or \
                pt.launches_banded.count != pt.launches.count:
            raise AssertionError(
                f"sharded-A launched K1 {pt.launches.count} times, "
                f"{pt.launches_banded.count} of them banded")
        if not torch.equal(got, want_eager):
            raise AssertionError(
                "sharded-A at world size 1 differs from the single-device "
                f"lean B' at {int((got != want_eager).sum())} values")
        pt.launches.reset()
        t = time.perf_counter()
        got = synthesize_spatial(*ex, cfg_head, make_mesh(1,
                                 device_type=dev.type))
        torch.cuda.synchronize()
        rec["spatial_ws1_wall_s"] = time.perf_counter() - t
        rec["k1_launches_spatial"] = pt.launches.count
        if not torch.equal(got, want_head):
            raise AssertionError(
                "spatial at world size 1 differs from the single-device "
                f"headline at {int((got != want_head).sum())} values")

        # Config 5's frames over the "batch" axis of one NCCL rank.
        a5, ap5, frames5 = npr_frames(n_frames=CONFIG5_FRAMES,
                                      size=batch_size)
        cfg5 = SynthConfig(**{**CONFIG5, "device": dev.type})
        want5, wall5 = run_batch(a5, ap5, frames5, cfg5,
                                 frames_per_step=CONFIG5_FPS)
        rec["single_batch_wall_s"] = wall5
        mesh5 = make_mesh(1, axis_names=("batch",), device_type=dev.type)
        pt.launches.reset()
        got, wall5 = run_batch(a5, ap5, frames5, cfg5,
                               frames_per_step=CONFIG5_FPS, mesh=mesh5)
        rec["batch_ws1_wall_s"] = wall5
        rec["k1_launches_batch"] = pt.launches.count
        want_k1 = batch_k1_launches(cfg5, batch_size, CONFIG5_FRAMES,
                                    CONFIG5_FPS)
        if pt.launches.count != want_k1:
            raise AssertionError(
                f"the batch runner over a mesh launched K1 "
                f"{pt.launches.count} times, not {want_k1}")
        if not torch.equal(got, want5):
            raise AssertionError(
                "the batch runner at world size 1 differs from "
                "synthesize_batch without a mesh at "
                f"{int((got != want5).sum())} values")
    finally:
        if not had_world and dist.is_initialized():
            dist.destroy_process_group()

    t = time.perf_counter()
    got, rank0_wall = spawn(multi_gloo_rank, 2, backend="gloo",
                            device_type=dev.type, devices=[0, 0],
                            args=(size, dev.type), timeout_s=600.0)
    rec["sharded_a_gloo2_wall_s"] = rank0_wall
    rec["sharded_a_gloo2_spawn_s"] = time.perf_counter() - t
    if not torch.equal(got, want_eager.cpu()):
        raise AssertionError(
            "sharded-A over two gloo ranks differs from the "
            f"single-device lean B' at "
            f"{int((got != want_eager.cpu()).sum())} values")

    # The command line: its own process, one NCCL rank.
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "multi_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        run_cli(["examples", "--out", work, "--size", str(cli_size)])
        sr = assets(work, "super_resolution")
        cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2,
                          pm_iters=6, device=dev.type)
        lib_out, _ = run_synth(sr, cfg)
        out = f"{work}/spatial.png"
        wall, _ = run_cli(synth_args(
            work, "super_resolution", out, *CLI_HEADLINE, "--device",
            dev.type, "--spatial", "--n-devices", "1"))
        rec["cli_spatial_wall_s"] = wall
        got, want = png(out), to_uint8(lib_out)
        if not np.array_equal(got, want):
            raise AssertionError(
                "synth --spatial --n-devices 1 PNG differs from the "
                f"library's B' at {int((got != want).sum())} values")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# Multi-device serving (`serve --n-devices N`, serving/ranks.py) on the
# serve cell's frames and knobs.

SERVE_MULTI_SWEEP = ((1, 4), (4, 2))
SERVE_MULTI_KILL_BURST = 4


def serve_multi_world(a, ap, dev, work_dir, **daemon_kw):
    """This process as rank 0 of two gloo ranks on cuda:0 (the follower
    spawned, as the multi phase's gloo arm is), the in-process daemon at
    grain 4 over them, its files in `work_dir`: (daemon, mesh, registry,
    previous registry)."""
    import os

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.parallel.mesh import start_world
    from image_analogies_tpu_torch.serving.daemon import SynthDaemon
    from image_analogies_tpu_torch.serving.ranks import ServingMesh, follow
    from image_analogies_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
        set_registry,
    )

    devices = [0, 0] if dev.type == "cuda" else None
    if dev.type == "cuda":
        # Rank 0's peak from here on, not the earlier phases'.
        torch.cuda.reset_peak_memory_stats()
    followers = start_world(2, follow, backend="gloo", device_type=dev.type,
                            devices=devices, timeout_s=600.0)
    mesh = ServingMesh(followers, a, ap, device_type=dev.type,
                       timeout_s=600.0)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
                      device=dev.type)
    d = SynthDaemon(a, ap, cfg, registry=reg, mesh=mesh,
                    max_batch=SERVE_GRAIN, max_wait_ms=25.0,
                    max_queue_depth=SERVE_QUEUE_DEPTH, obs_interval_s=0,
                    work_dir=work_dir, **daemon_kw)
    os.makedirs(work_dir, exist_ok=True)
    return d.start(), mesh, reg, prev


def multi_sweep(url, bodies, refs, tag):
    """SERVE_MULTI_SWEEP against one daemon, every 200 bit-equal to the
    library's grain-4 dispatch."""
    points = []
    for clients, per in SERVE_MULTI_SWEEP:
        point = serve_point(url, clients, per, bodies, refs,
                            f"{tag}-c{clients}")
        point.pop("routed_to")
        point.pop("routes")
        if point["completed"] != point["requests"]:
            raise AssertionError(f"serve_multi {tag}: {point}")
        points.append(point)
    return points


def phase_serve_multi(dev, smi, serve=None, size=SERVE_SIZE,
                      kill_size=KILL_SIZE):
    """Multi-device serving on the card, on the serve cell's frames and
    knobs (config 5's `npr_frames(8, size)`, 5 levels, PatchMatch, em 2,
    kappa 2, grain 4): (a) `serve --n-devices 1` over NCCL at world size
    1, a CLI process with a warmup at size^2, swept 1 x 4 and 4 x 2;
    (b) two gloo ranks on cuda:0 (this process rank 0, the daemon in it),
    the same sweeps at 2 frames a rank, K1 captured from rank 0's first
    2-frame launch and held against its plain version, then a drain that
    ends both ranks with exit 0; (c) at kill_size^2, two gloo ranks with
    a state dir, the follower SIGKILLed during a 4-client burst (answers
    200 or 503 with Retry-After, /healthz 503, drained), then `serve
    --takeover` at world size 1 replaying every journaled request
    bit-identically.  Every 200 answer equals `library_dispatch` bit for
    bit; K1 launches are counted per rank per dispatch; walls, p50/p99
    and frames/s stand beside the serve phase's single daemon."""
    import os
    import shutil
    import signal
    import threading

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.serving.accesslog import read_entries
    from image_analogies_tpu_torch.serving.journal import journal_path
    from image_analogies_tpu_torch.telemetry.metrics import set_registry
    from image_analogies_tpu_torch.utils.examples import npr_frames
    from image_analogies_tpu_torch.utils.io import (
        load_image,
        save_image,
        to_uint8,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "serve_multi_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rec = {"phase": "serve_multi", "nvidia_smi": smi, "size": size,
           "grain": SERVE_GRAIN}
    a0, ap0, frames = npr_frames(n_frames=8, size=size)
    save_image(f"{work}/A.png", a0)
    save_image(f"{work}/Ap.png", ap0)
    a, ap = load_image(f"{work}/A.png"), load_image(f"{work}/Ap.png")
    frames_u8 = [to_uint8(f) for f in frames]
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2, kappa=2.0,
                      device=dev.type)
    refs = SERVE_MEMO.get("refs") or [
        library_dispatch(a, ap, as_float(f), cfg) for f in frames_u8]
    bodies = [serve_body(f) for f in frames_u8]
    want_k1 = batch_k1_launches(cfg, size, SERVE_GRAIN // 2,
                                SERVE_GRAIN // 2)
    with open(f"{work}/warmup.json", "w") as f:
        json.dump({"schema_version": 1, "kind": "serve_warmup", "entries": [
            {"height": size, "width": size}]}, f)
    if serve:
        rec["single_daemon"] = [
            {k: p[k] for k in ("clients", "requests", "p50_ms", "p99_ms",
                               "frames_per_s", "server_wall_ms_median")}
            for p in serve["record"]["sweep"]]

    # (a) `serve --n-devices 1`: one NCCL rank, the CLI's world.
    proc, url, rec["ws1_startup_s"] = serve_up(work, "ws1", [
        "--a", f"{work}/A.png", "--ap", f"{work}/Ap.png",
        "--device", dev.type, "--n-devices", "1",
        "--max-batch", str(SERVE_GRAIN), "--max-wait-ms", "25",
        "--max-queue-depth", str(SERVE_QUEUE_DEPTH),
        "--warmup", f"{work}/warmup.json", *SERVE_KNOBS])
    try:
        rec["ws1_sweep"] = multi_sweep(url, bodies, refs, "ws1")
        serving = json.loads(http_get(url + "/serving")[1])
    finally:
        rc = stop(proc)
    ranks = serving["ranks"]
    rec["ws1_ranks"] = ranks
    if rc != 0 or serving["devices"] != 1 or ranks["backend"] != (
            "nccl" if dev.type == "cuda" else "gloo"):
        raise AssertionError(f"serve --n-devices 1: exit {rc}, {ranks}")
    if ranks["k1_launches_last_dispatch"] != [
            batch_k1_launches(cfg, size, SERVE_GRAIN, SERVE_GRAIN)]:
        raise AssertionError(f"serve --n-devices 1: K1 {ranks}")
    emit({"phase": "serve_multi", "part": "ws1", "sweep": rec["ws1_sweep"],
          "startup_s": rec["ws1_startup_s"],
          "k1_launches_per_dispatch": ranks["k1_launches_last_dispatch"],
          "peak_bytes": ranks["peak_bytes"]})

    # (b) Two gloo ranks on one card, 2 frames a rank.
    t = time.perf_counter()
    d, mesh, reg, prev = serve_multi_world(a, ap, dev, f"{work}/gloo2")
    rec["gloo2_world_s"] = time.perf_counter() - t
    try:
        t = time.perf_counter()
        d.warmup([{"height": size, "width": size, "channels": 3}])
        rec["gloo2_warmup_s"] = time.perf_counter() - t
        for counter in (pt.launches, pt.launches_int8):
            counter.reset()
        warm_launches = sum(mesh.k1_launches)
        with capture_first(pt, "tile_sweep", lambda *a_, **k: (
                a_[1].ndim == 4 and a_[1].shape[0] == SERVE_GRAIN // 2
                and k["ha"] == size)) as seen:
            rec["gloo2_sweep"] = multi_sweep(d.url, bodies, refs, "gloo2")
        snap = mesh.snapshot()
        rec["gloo2_ranks"] = snap
        # Every rank's launches over the sweeps (the warmup's before).
        rec["k1_launches"] = sum(snap["k1_launches"]) - warm_launches
        rec["k1_launches_rank0_counter"] = pt.launches.count
        if (snap["k1_launches_last_dispatch"] != [want_k1, want_k1]
                or (dev.type == "cuda" and min(snap["k1_launches"]) == 0)):
            raise AssertionError(f"two gloo ranks: K1 {snap}, want "
                                 f"{want_k1} a rank a dispatch")
        d.begin_drain(reason="sigterm")
        if not d.drained.wait(120):
            raise AssertionError("two gloo ranks: the drain did not end")
    finally:
        d.stop()
        rec["gloo2_exit_codes"] = mesh.close()
        set_registry(prev)
    if rec["gloo2_exit_codes"] != [0]:
        raise AssertionError(f"two gloo ranks: follower exit "
                             f"{rec['gloo2_exit_codes']}")
    if seen:
        args, kw, _ = seen[0]
        kw = {k: kw[k] for k in ("specs", "geom", "ha", "wa", "coh_factor")}
        rec["k1_frames"] = k1_frames_row(args, kw)
    elif dev.type == "cuda":
        raise AssertionError("two gloo ranks: no 2-frame K1 launch seen")
    emit({"phase": "serve_multi", "part": "gloo2",
          "sweep": rec["gloo2_sweep"], "world_s": rec["gloo2_world_s"],
          "warmup_s": rec["gloo2_warmup_s"],
          "k1_launches_per_rank_per_dispatch":
              rec["gloo2_ranks"]["k1_launches_last_dispatch"],
          "peak_bytes": rec["gloo2_ranks"]["peak_bytes"],
          "k1_frames": rec.get("k1_frames")})

    # (c) A follower SIGKILLed mid-burst at kill_size^2, then a takeover.
    n = kill_size
    save_image(f"{work}/A{n}.png", a0[:n, :n])
    save_image(f"{work}/Ap{n}.png", ap0[:n, :n])
    a_n, ap_n = load_image(f"{work}/A{n}.png"), load_image(f"{work}/Ap{n}.png")
    small = [np.ascontiguousarray(f[:n, :n])
             for f in frames_u8[:SERVE_MULTI_KILL_BURST]]
    small_refs = [library_dispatch(a_n, ap_n, as_float(f), cfg)
                  for f in small]
    state = f"{work}/kill_state"
    d, mesh, reg, prev = serve_multi_world(a_n, ap_n, dev, f"{work}/kill",
                                           state_dir=state)
    results = {}
    try:
        pid = mesh.followers.pids[0]

        def client(i):
            results[i] = serve_post(d.url, small[i], rid=f"kill-{i}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(small))]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 300
        while d._inflight < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("kill arm: nothing went in flight")
            time.sleep(0.002)
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        for th in threads:
            th.join(300)
        rec["kill_answered_s"] = time.perf_counter() - t_kill
        drained = d.drained.wait(120)
        health = d.health()
        code_h, _ = http_get(d.url + "/healthz", 30)
        lost = d.world_lost
    finally:
        d.stop()
        rec["kill_exit_codes"] = mesh.close()
        set_registry(prev)
    codes = {i: r[0] for i, r in results.items()}
    rec["kill_codes"] = codes
    if not (drained and lost and code_h == 503
            and health["verdict"] == "violated"):
        raise AssertionError(f"kill arm: drained {drained}, lost {lost}, "
                             f"/healthz {code_h}")
    for i, (code, body, hdrs, _) in results.items():
        if code == 200:
            if not np.array_equal(served_image(body), small_refs[i]):
                raise AssertionError(f"kill arm: answer {i} differs")
        elif code != 503 or int(hdrs.get("Retry-After", 0)) < 1:
            raise AssertionError(f"kill arm: {i} answered {code}")
    entries = list(read_entries(journal_path(state)))
    pending = ({e["request_id"] for e in entries if e["kind"] == "req"}
               - {e["request_id"] for e in entries if e["kind"] == "mark"})
    journaled_503 = {f"kill-{i}" for i, c in codes.items() if c == 503
                     and "lost a rank" in results[i][1].get("error", "")}
    if pending != journaled_503:
        raise AssertionError(f"kill arm: pending {pending}, 503s "
                             f"{journaled_503}")
    proc, url, _ = serve_up(work, "takeover", [
        "--a", f"{work}/A{n}.png", "--ap", f"{work}/Ap{n}.png",
        "--device", dev.type, "--n-devices", "1",
        "--max-batch", str(SERVE_GRAIN), "--max-wait-ms", "25",
        "--takeover", state, *SERVE_KNOBS])
    try:
        deadline = time.perf_counter() + 300
        while True:
            journal = json.loads(http_get(url + "/journal")[1])
            if set(journal["replayed"]) >= pending:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"takeover: {journal}")
            time.sleep(0.05)
    finally:
        rc = stop(proc)
    for rid in pending:
        if journal["replayed"][rid]["sha256"] != sha(
                small_refs[int(rid.split("-")[1])]):
            raise AssertionError(f"takeover: {rid} replayed differently")
    if rc != 0:
        raise AssertionError(f"takeover exited {rc}")
    rec.update(kill_pending=sorted(pending), kill_replayed=len(pending),
               kill_acknowledged_lost=0, kill_health=code_h)
    emit({"phase": "serve_multi", "part": "kill",
          **{k: rec[k] for k in ("kill_codes", "kill_answered_s",
                                 "kill_exit_codes", "kill_pending",
                                 "kill_health")}})
    emit(rec)
    shutil.rmtree(work, ignore_errors=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    script_t0 = time.perf_counter()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import image_analogies_tpu_torch  # noqa: F401  (fails outside the repo)
    from image_analogies_tpu_torch import kernels

    import os

    record = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "chiprun_out", "chip_smoke.jsonl")
    if os.path.exists(record):
        os.remove(record)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    build_s = kernels.build_all()
    logs = {}
    for name in kernels.SOURCES:
        log = kernels.BUILD_DIR / f"{name}.log"
        if log.exists():
            logs[name] = [ln for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": logs})

    rng = np.random.default_rng(0)
    case = real = l2_rate = None
    seconds = {}

    def run(name, fn, *a):
        """One phase, its `seconds` on every line it emits."""
        PHASE_T0[0] = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - PHASE_T0[0]
        return out

    if phases & {"k1", "k1i8", "cli", "telemetry", "multi"}:
        l2_rate = run("l2", kernels.l2_read_rate, dev)
        emit({"phase": "l2", "nvidia_smi": smi,
              "l2_read_bytes_per_s": l2_rate})
    if phases & {"k1", "k1i8", "multi"}:
        case = run("k1_case", k1_case, dev, rng)
    if phases & {"k1", "k1i8"}:
        real = run("k1_real_case", capture_real_case, dev)
    k1 = run("k1", phase_k1, dev, case, real, l2_rate) \
        if "k1" in phases else {}
    k2 = run("k2", phase_k2, dev, rng) if "k2" in phases else {}
    k3 = run("k3", phase_k3, dev, rng) if "k3" in phases else {}
    k4 = run("k4", phase_k4, dev, rng, l2_rate) if "k4" in phases else {}
    k1i8 = run("k1i8", phase_k1i8, dev, case, real, l2_rate) \
        if "k1i8" in phases else {}
    # Launch counts come from the main-path phases; null when not run.
    k1_launches = k2_launches = k1i8_launches = k3_launches = None
    k4_launches = None
    if "headline" in phases:
        head, k1_launches = run("headline", phase_headline, dev)
        k4_launches = head["k4_launches_per_run"][-1]
    if "compressed" in phases:
        comp = run("compressed", phase_compressed, dev)
        k1i8_launches = comp["k1_int8_launches_per_run"]
        k3_launches = comp["k3_launches_per_run"]
    if "config1" in phases:
        _, k2_launches = run("config1", phase_config1, dev)
    if "quality" in phases:
        run("quality", phase_quality, dev, k2.get("achieved_tflops", 1.0))
    if "profile" in phases:
        run("profile", phase_profile, dev)
    lean = run("lean", phase_lean, dev, smi, script_t0) \
        if "lean" in phases else {}
    batch = run("batch", phase_batch, dev, smi) if "batch" in phases else {}
    if "video" in phases:
        run("video", phase_video, dev, smi)
    cli = run("cli", phase_cli, dev, smi, l2_rate) if "cli" in phases else {}
    if "telemetry" in phases:
        run("telemetry", phase_telemetry, dev, smi, l2_rate)
    serve = run("serve", phase_serve, dev, smi, script_t0) \
        if "serve" in phases else {}
    fleet = run("fleet", phase_fleet, dev, smi, serve) \
        if "fleet" in phases else {}
    multi = run("multi", phase_multi, dev, smi, case, l2_rate) \
        if "multi" in phases else {}
    serve_multi = run("serve_multi", phase_serve_multi, dev, smi, serve) \
        if "serve_multi" in phases else {}
    PHASE_T0[0] = script_t0
    emit({"phase": "timing", "seconds_by_phase": seconds,
          "build_s": build_s})

    kernels_line = []
    if k1:
        kernels_line.append({
            "name": "tile_sweep", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": k1_launches, "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": None,
        })
    if k1i8:
        kernels_line.append({
            "name": "tile_sweep_int8", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:1034",
            "launches": k1i8_launches, "max_abs_err": k1i8["max_abs_err"],
            "ms": k1i8["ms"], "plain_ms": k1i8["plain_ms"],
            "bound_ms": k1i8["bound_ms"], "bound_by": k1i8["bound_by"],
            "library_ms": None,
        })
    if k2:
        kernels_line.append({
            "name": "nn_argmin", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/nn_brute.cu",
            "replaces": "image_analogies_tpu/kernels/nn_brute.py:69",
            "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
            "library_ms": k2["library_ms"],
        })
    if k3:
        # The compressed path's K3 launches gather the int8 table.
        t = k3["int8"]
        kernels_line.append({
            "name": "gather_rows", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/row_gather.cu",
            "replaces": "image_analogies_tpu/kernels/polish_stream.py:172",
            "launches": k3_launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # K4 at the 64^2 per-pixel level and at the 1024^2 polish, beside the
    # headline's launches (both shapes together).  It replaces no TPU
    # kernel: XLA fused the JAX package's cascade.
    for name, shape in (("pixel_cascade", "pixel"),
                        ("pixel_cascade_polish", "polish")) if k4 else ():
        t = k4[shape]
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/"
                      "pixel_cascade.cu",
            "replaces": None, "launches": k4_launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    if lean:
        # The lean path's rows: each kernel timed and checked on a launch
        # the lean path made (captured with its inputs), beside the
        # launches per run of the arm that made it (K1: the 4096^2 run's
        # first level-0 sweep; K1 int8 and K3: the 2048^2 compressed
        # arm's first lean-level launches; K2: the 2048^2 lean oracle's
        # first level-1 launch, 1,048,576 x 1,048,576 rows, whose plain
        # version takes seconds where level 0's takes minutes).
        for name, row, launches, src, replaces in (
            ("tile_sweep_lean", lean["k1_4096_first_sweep"],
             lean["launches_4096"]["k1"], "tile_sweep",
             "patchmatch_tile.py:888"),
            ("tile_sweep_int8_lean",
             lean["k1_int8_2048_compressed_first_sweep"],
             lean["launches_2048_compressed"]["k1_int8"], "tile_sweep",
             "patchmatch_tile.py:1034"),
            ("nn_argmin_bf16_lean", lean["k2_2048_oracle_level1"],
             lean["k2_launches_oracle_2048"], "nn_brute", "nn_brute.py:69"),
            ("gather_rows_lean", lean["k3_2048_compressed_first_launch"],
             lean["launches_2048_compressed"]["k3"], "row_gather",
             "polish_stream.py:172"),
        ):
            kernels_line.append({
                "name": name, "route": "cuda",
                "source": f"image_analogies_tpu_torch/kernels/csrc/{src}.cu",
                "replaces": f"image_analogies_tpu/kernels/{replaces}",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
            })
    if batch:
        # K1 with the frame axis: config 5's first 4-frame level-0 sweep,
        # beside the launches of one config-5 run (one a sweep a chunk).
        row = batch["k1_frames"]
        kernels_line.append({
            "name": "tile_sweep_frames", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": batch["k1_launches_per_run"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    if cli:
        # K1 at steerable width: config 4's first level-0 sweep (12
        # channels with the coarse pair), beside config 4's launches.
        row = cli["k1_steerable"]
        kernels_line.append({
            "name": "tile_sweep_steerable", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": cli["config4"]["k1_launches_per_run"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    if serve:
        # K1 with the frame axis on the serving path: the in-process
        # daemon's grain-4 dispatch, captured and held against the plain
        # version, beside the launches the `serve` process booked over
        # its traffic (warmup, cold shape, sweep, session).
        row = serve["inproc"]["k1_frames"]
        kernels_line.append({
            "name": "tile_sweep_frames_serve", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": serve["record"]["k1_launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    if fleet:
        # K1 with the frame axis behind the router: the library's
        # dispatch of the lattice's padded 1024^2 frame, captured and held
        # against the plain version, beside the launches the replicas
        # booked over the routed sweep.
        row = fleet["k1_frames"]
        kernels_line.append({
            "name": "tile_sweep_frames_fleet", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": fleet["k1_launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    if multi:
        # K1's banded mode: one band of two at the 1024^2 level 0
        # (seeded case), beside the banded launches of the sharded-A
        # headline (every sweep of its lean levels is one band launch).
        row = next(r for r in multi["k1_banded"]
                   if r["dtype"] == "bf16" and r["n_bands"] == 2)
        kernels_line.append({
            "name": "tile_sweep_banded", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": multi["k1_banded_launches"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in multi["k1_banded"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
        })
    if serve_multi.get("k1_frames"):
        # K1 with the frame axis on multi-device serving: rank 0's first
        # 2-frame launch (grain 4 over two ranks), held against the
        # plain version, beside the launches every rank booked over the
        # two-rank arm's sweeps.
        row = serve_multi["k1_frames"]
        kernels_line.append({
            "name": "tile_sweep_frames_serve_multi", "route": "cuda",
            "source": "image_analogies_tpu_torch/kernels/csrc/tile_sweep.cu",
            "replaces": "image_analogies_tpu/kernels/patchmatch_tile.py:888",
            "launches": serve_multi["k1_launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

    python3 chip_smoke.py --phases k1,k1i8,k2,config1   # K1 and K2 only

    python3 chip_smoke.py --phases lean   # 2048^2 and 4096^2 only

    python3 chip_smoke.py --phases batch,video   # config 5 and video

    python3 chip_smoke.py --phases cli   # the command line, configs 2, 4

Builds the port's CUDA kernels from `image_analogies_tpu_torch/kernels/
csrc/`, holds each kernel against its plain PyTorch version at the main
path's shapes (K1 in float32 and int8 mode, on a seeded case and on the
tables and state of the headline's first level-0 sweep; K2 on float32
and bfloat16 rows, at 65,536^2 x 68 and at a ragged 10,007 x 9,001 x
150; K3 on bf16 and int8 tables), drives the main paths through
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
4 against their brute oracles with K1 at steerable width), checks the
outputs and their PSNR against the brute oracle, and the batch and
video runners' isolation and gates, and prints one JSON line per
phase.  The line before the
last is the `kernels` summary; the last is `{"ok": true, "device":
{...}}`.  Any
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
import contextlib
import json
import math
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
PHASES = ("k1", "k2", "k3", "k1i8", "headline", "compressed", "config1",
          "quality", "profile", "lean", "batch", "video", "cli")
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median milliseconds of `fn` over `reps` runs, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def k1_case(dev, rng):
    """K1's inputs at the headline's level-0 shapes: 1024^2 B and A, 4
    channels with the coarse pair, seeded candidate tables with invalid
    slots, an incoming state; returns (A images, args, kw)."""
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    cfg = SynthConfig()
    h = w = ha = wa = 1024
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
    from image_analogies_tpu_torch.kernels import nn_brute, patchmatch_tile
    from image_analogies_tpu_torch.utils.examples import super_resolution

    ex = super_resolution(1024)
    cfg = SynthConfig(**HEADLINE)
    run_synth(ex, cfg)  # warm
    walls, counts = [], []
    out = None
    for _ in range(3):
        patchmatch_tile.launches.reset()
        nn_brute.launches.reset()
        out, wall = run_synth(ex, cfg)
        counts.append(patchmatch_tile.launches.count)
        walls.append(wall)
        if patchmatch_tile.launches.count != 48:
            raise AssertionError(
                f"K1 launched {patchmatch_tile.launches.count} times, not 48"
            )
    std = check_output(out, ex[2].shape, "headline")
    rec = {"phase": "headline", "size": 1024, "levels": 5,
           "wall_s_median": statistics.median(walls), "walls_s": walls,
           "k1_launches_per_run": counts, "bp_std": std}
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
    ops with the most self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    for ev in prof.key_averages():
        # Device-side events (kernels, memcpy, memset) apart: the CPU ops
        # that launched them carry the same device time again.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((ev.self_cpu_time_total, ev.key, ev.count))
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy_ms = sum(t for t, _, _ in rows) / 1e3
    rec = {
        "phase": "profile", "arm": arm, "wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "device_events": sum(n for _, _, n in rows),
        "top": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                for t, k, n in rows[:12]],
        "host_top": [{"name": k[:90], "self_cpu_ms": t / 1e3, "calls": n}
                     for t, k, n in host[:8]],
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
    """(result, milliseconds) of one call of `fn`, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    prof = profile_call(lambda: run_synth(ex2, cfg), "lean_2048")
    rec["profile_2048"] = {k: prof[k] for k in (
        "wall_s", "device_busy_ms", "device_idle_share", "device_events")}

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
    f_b, f_a, *_ = seen1[0][0]
    rec["k2_2048_oracle_level1"] = lean_k2_row(f_b, f_a, seen1[0][2])
    f_b, f_a, *_ = seen[0][0]
    rec["k2_2048_oracle_level0"] = lean_k2_level0(f_b, f_a, seen[0][2])
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

    rec["k1_frames"] = k1_frames_row(args, kw)
    prof = profile_call(lambda: run_batch(a, ap, frames, cfg,
                                          frames_per_step=fps), "config5")
    rec["profile"] = {k: prof[k] for k in (
        "wall_s", "device_busy_ms", "device_idle_share", "device_events")}
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


def stream_pass(dev, a, ap, stack, cfg, warm):
    """One frame-at-a-time pass through `VideoStream`: (outputs, per-frame
    walls, the stream)."""
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
        for t in range(stack.shape[0]):
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
    (warm off), with tools/check_video.py's gates raised on, and warm
    frame 0 and the warm-off pass held bit for bit against
    `synthesize_batch(frames_per_step=1)`."""
    import dataclasses

    from image_analogies_tpu_torch import psnr, synthesize_batch
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import nn_brute
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.video import (
        flicker_metric,
        set_warm_mode,
        warm_mode,
    )

    t_phase = time.perf_counter()
    n, size = VIDEO_FRAMES, VIDEO_SIZE
    cfg = SynthConfig(**{**VIDEO, "device": dev.type})
    a, ap, stack = make_scene(size, n, cfg.seed)
    rec = {"phase": "video", "nvidia_smi": smi, "frames": n, "size": size,
           "config": {**{k: v for k, v in VIDEO.items() if k != "device"},
                      "tau": VIDEO_TAU}}
    stream_pass(dev, a, ap, stack[:2], cfg, "on")  # warm-up
    passes = {}
    for name, c, warm in (
            ("cold", cfg, "off"), ("warm", cfg, "on"),
            ("warm_tau", dataclasses.replace(cfg, tau=VIDEO_TAU), "on"),
            ("oracle", dataclasses.replace(cfg, matcher="brute"), "off")):
        pt.launches.reset()
        nn_brute.launches.reset()
        out, walls, stream = stream_pass(dev, a, ap, stack, c, warm)
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
        }
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
    # Where a frame's time goes: one warm (tau 0) and one cold frame of a
    # primed stream under the profiler.
    for name, mode in (("warm", "on"), ("cold", "off")):
        _, _, stream = stream_pass(dev, a, ap, stack[:1], cfg, "on")
        prev = warm_mode()
        set_warm_mode(mode)
        try:
            prof = profile_call(lambda: stream.step(stack[1]),
                                f"video_{name}_frame")
        finally:
            set_warm_mode(prev)
        rec[f"profile_{name}_frame"] = {k: prof[k] for k in (
            "wall_s", "device_busy_ms", "device_idle_share",
            "device_events")}
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
ANN_MIN_PSNR = 30.0  # tests/test_ann.py's bar for ann against brute
CHAOS_PLANS = ("level:1:raise", "kernel:0:raise")


def run_cli(args, env=None, timeout=900):
    """One `python -m image_analogies_tpu_torch.cli` process from the
    repository root: (its wall in seconds, its stdout); raises on a
    non-zero exit."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", *args],
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

    # ann on config 1's inputs: eps 0 against the brute oracle, and
    # eps 0.5 with 12 PCA dims against brute with 12.  On the brute run's
    # first coarsest-level tables (the same inputs for both matchers) the
    # tree's picks are exact and differ from K2's only at ties (the K2
    # tie rule); end to end the EM steps carry such a tie on, so the B'
    # is held by PSNR.
    from image_analogies_tpu_torch.models import brute as brute_mod
    from image_analogies_tpu_torch.models.ann import _host_ann_query

    if not native.ann_available():
        raise AssertionError("the native kd-tree did not build")
    tbn = assets(dirs[small], "texture_by_numbers")
    n_coarse = (small // 4) ** 2
    with capture_first(brute_mod, "nn_argmin",
                       lambda f_b, *a, **k: f_b.shape[0] == n_coarse) as seen:
        brute = create_image_analogy(
            *tbn, SynthConfig(**CONFIG1, device=device), return_aux=True)
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
    ckpt, prog0 = f"{work}/ann_ckpt", f"{work}/ann0.jsonl"
    ann_args = ["--levels", "3", "--em-iters", "2", "--matcher", "ann",
                "--device", device]
    run_cli(synth_args(dirs[small], "texture_by_numbers", f"{work}/ann0.png",
                       *ann_args, "--ann-eps", "0", "--progress", prog0,
                       "--save-level-artifacts", ckpt))
    differing = {}
    for lv in range(3):
        with np.load(f"{ckpt}/level_{lv}.npz") as z:
            differing[lv] = int(np.any(
                z["nnf"] != brute["nnf"][lv].cpu().numpy(), -1).sum())
    ann0 = load_image(f"{work}/ann0.png")
    p0 = psnr(ann0, to_uint8(brute["bp"]) / 255.0)
    if not p0 >= ANN_MIN_PSNR:
        raise AssertionError(f"ann eps 0 vs brute: {p0} dB")
    prog1 = f"{work}/ann1.jsonl"
    run_cli(synth_args(dirs[small], "texture_by_numbers", f"{work}/ann1.png",
                       *ann_args, "--ann-eps", "0.5", "--pca-dims", "12",
                       "--progress", prog1))
    brute12 = create_image_analogy(*tbn, SynthConfig(
        **CONFIG1, pca_dims=12, device=device))
    rec["ann"] = {
        "eps0_coarsest_tables_vs_k2": coarsest,
        "eps0_wall_s": cli_done_wall(prog0),
        "eps0_pixels_differing_from_brute_by_level": differing,
        "eps0_psnr_vs_brute_db": p0,
        "eps0_values_differing_from_brute_png": float(
            (png(f"{work}/ann0.png") != to_uint8(brute["bp"])).mean()),
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
        run_cli(synth_args(dirs[big], "super_resolution", out,
                           *CLI_HEADLINE, "--device", device, "--progress",
                           prog, *extra),
                env={"IA_FAULT_PLAN": plan} if plan else None)
        chaos[arm] = {"wall_s": cli_done_wall(prog),
                      "walls_ms": cli_level_walls(prog)}
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
    if phases & {"k1", "k1i8", "cli"}:
        l2_rate = kernels.l2_read_rate(dev)
        emit({"phase": "l2", "nvidia_smi": smi,
              "l2_read_bytes_per_s": l2_rate})
    if phases & {"k1", "k1i8"}:
        case = k1_case(dev, rng)
        real = capture_real_case(dev)
    k1 = phase_k1(dev, case, real, l2_rate) if "k1" in phases else {}
    k2 = phase_k2(dev, rng) if "k2" in phases else {}
    k3 = phase_k3(dev, rng) if "k3" in phases else {}
    k1i8 = phase_k1i8(dev, case, real, l2_rate) if "k1i8" in phases else {}
    # Launch counts come from the main-path phases; null when not run.
    k1_launches = k2_launches = k1i8_launches = k3_launches = None
    if "headline" in phases:
        _, k1_launches = phase_headline(dev)
    if "compressed" in phases:
        comp = phase_compressed(dev)
        k1i8_launches = comp["k1_int8_launches_per_run"]
        k3_launches = comp["k3_launches_per_run"]
    if "config1" in phases:
        _, k2_launches = phase_config1(dev)
    if "quality" in phases:
        phase_quality(dev, k2.get("achieved_tflops", 1.0))
    if "profile" in phases:
        phase_profile(dev)
    lean = phase_lean(dev, smi, script_t0) if "lean" in phases else {}
    batch = phase_batch(dev, smi) if "batch" in phases else {}
    if "video" in phases:
        phase_video(dev, smi)
    cli = phase_cli(dev, smi, l2_rate) if "cli" in phases else {}

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
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Builds the port's CUDA kernels from `image_analogies_tpu_torch/kernels/
csrc/`, holds each kernel against its plain PyTorch version at the main
path's shapes, drives the main path through `create_image_analogy`
(the 1024^2 super-resolution headline with PatchMatch, and
texture-by-numbers at 256^2 with the brute oracle), checks the output
and its PSNR against the brute oracle, and prints one JSON line per
phase.  The line before the last is the `kernels` summary; the last is
`{"ok": true, "device": {...}}`.  Any failed phase raises, so the script
exits non-zero and prints no result line; so does a machine without a
CUDA device.

Bounds (`bound_ms`) use the H100 SXM's published peaks: 67 TFLOP/s of
FP32 on the CUDA cores and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PHASES = ("k1", "k2", "headline", "config1", "quality", "profile")


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


def bound_ms(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def phase_k1(dev, rng):
    """K1 against its plain version at the headline's level-0 shapes:
    1024^2 B and A, 4 channels with the coarse pair, seeded candidate
    tables with invalid slots, an incoming state, and kappa > 1."""
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

    got = pt.tile_sweep_kernel(*args, **kw)
    want = pt.tile_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    kd, pd = got[2][:h, :w], want[2][:h, :w]
    if not bool(torch.isfinite(pd).all()):
        raise AssertionError("K1 plain version left a pixel at +inf")
    changed = float((pd != d_in[:h, :w]).float().mean())
    tol = 1e-5 + 1e-4 * pd.abs()
    close = (kd - pd).abs() <= tol
    if not bool(close.all()):
        raise AssertionError(
            f"K1 distances disagree at {int((~close).sum())} pixels"
        )
    # Offsets: equal, except where the kernel's own offset reaches a
    # distance within the tolerance of the plain winner's (a tie).
    off_diff = (got[0][:h, :w] != want[0][:h, :w]) | (
        got[1][:h, :w] != want[1][:h, :w])
    bad = pt.unexplained_offsets(got, want, (oy, ox, d_in), a_planes,
                                 b_planes, specs=specs, geom=geom, ha=ha,
                                 wa=wa, h=h, w=w)
    if bool(bad.any()):
        raise AssertionError(
            f"K1 offsets differ off ties at {int(bad.sum())} pixels"
        )
    max_err = float((kd - pd).abs().max())
    ms = cuda_ms(lambda: pt.tile_sweep_kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: pt.tile_sweep_plain(*args, **kw), reps=10,
                       warm=1)
    n_valid = int(valid.sum())
    groups = pt.spec_groups(specs)
    flop_per_px = 3 * len(specs) + sum(
        4 * len(sp.wy) for sp, _ in groups
    ) + len(groups)
    flops = n_valid * geom.tile_h * geom.tile_w * flop_per_px
    state = geom.n_ty * geom.tile_h * geom.n_tx * geom.tile_w * 4
    nbytes = (a_planes.numel() + b_planes.numel()) * 4 + 3 * valid.numel() * 4 \
        + 6 * state
    rec = {
        "phase": "k1", "shape": [h, w, ha, wa], "channels": len(specs),
        "valid_slots": n_valid, "slots": int(valid.numel()),
        "max_abs_err": max_err, "changed_frac": changed,
        "offset_mismatch_frac": float(off_diff.float().mean()),
        "tol": "rtol 1e-4 / atol 1e-5; offsets equal off ties",
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(flops, nbytes),
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    emit(rec)
    return rec


def phase_k2(dev, rng):
    """K2 against its plain version at 65,536 x 65,536 x 68 float32 (the
    256^2 level 0), and the library yardstick."""
    from image_analogies_tpu_torch.kernels import nn_brute as nb
    from image_analogies_tpu_torch.models.matcher import candidate_dist

    n, d = 65536, 68
    f_b = torch.as_tensor(rng.random((n, d), dtype=np.float32), device=dev)
    f_a = torch.as_tensor(rng.random((n, d), dtype=np.float32), device=dev)
    a_sq = nb.squared_norms(f_a)
    idx_k = nb.nn_argmin_kernel(f_b, f_a, a_sq)
    idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq)
    torch.cuda.synchronize()
    d_k = candidate_dist(f_b, f_a, idx_k)
    d_p = candidate_dist(f_b, f_a, idx_p)
    differ = idx_k != idx_p
    tie = (d_k - d_p).abs() <= 1e-5 * d_p.abs()
    if bool((differ & ~tie).any()):
        raise AssertionError(
            f"K2 argmin differs off ties at {int((differ & ~tie).sum())} rows"
        )
    # Error of the result: the exact distances of the chosen rows.
    max_err = float((d_k - d_p).abs().max())

    def library():
        out = []
        for c in range(0, n, 8192):
            out.append(torch.argmin(
                a_sq[None, :] - 2.0 * torch.matmul(f_b[c:c + 8192], f_a.T),
                dim=-1,
            ))
        return torch.cat(out)

    ms = cuda_ms(lambda: nb.nn_argmin_kernel(f_b, f_a, a_sq))
    plain_ms = cuda_ms(lambda: nb.nn_argmin_plain(f_b, f_a, a_sq))
    library_ms = cuda_ms(library)
    flops = 2.0 * n * n * d
    nbytes = (2 * n * d + n) * 4 + n * 4
    rec = {
        "phase": "k2", "shape": [n, n, d], "rows_differ": int(differ.sum()),
        "max_abs_err": max_err,
        "tie": "exact f32 distances within 1e-5 rel",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms(flops, nbytes), "bound_by": "operations",
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }
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
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2,
                      pm_iters=6, pm_polish_iters=1, device="cuda")
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


def phase_profile(dev):
    """One headline run under torch.profiler: device time by kernel, and
    the device's idle share of the run's wall."""
    from torch.profiler import ProfilerActivity, profile

    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.utils.examples import super_resolution

    ex = super_resolution(1024)
    cfg = SynthConfig(levels=5, matcher="patchmatch", em_iters=2,
                      pm_iters=6, pm_polish_iters=1, device="cuda")
    run_synth(ex, cfg)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run_synth(ex, cfg)
    rows = []
    for ev in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same device time again.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(t for t, _, _ in rows) / 1e3
    rec = {
        "phase": "profile", "wall_s": wall, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "device_events": sum(n for _, _, n in rows),
        "top": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                for t, k, n in rows[:12]],
    }
    emit(rec)
    return rec


def phase_config1(dev):
    from image_analogies_tpu_torch.config import SynthConfig
    from image_analogies_tpu_torch.kernels import nn_brute, patchmatch_tile
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
    rec = {"phase": "config1", "size": 256, "wall_s": wall,
           "k2_launches": count, "bp_std": std}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
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
    k1 = phase_k1(dev, rng) if "k1" in phases else {}
    k2 = phase_k2(dev, rng) if "k2" in phases else {}
    # Launch counts come from the main-path phases; null when not run.
    k1_launches = k2_launches = None
    if "headline" in phases:
        _, k1_launches = phase_headline(dev)
    if "config1" in phases:
        _, k2_launches = phase_config1(dev)
    if "quality" in phases:
        phase_quality(dev, k2.get("achieved_tflops", 1.0))
    if "profile" in phases:
        phase_profile(dev)

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
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

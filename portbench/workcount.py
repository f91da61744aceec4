"""Work counts of the port's kernels and the H100's peaks: the yardstick
of the roofline shares.

Each count is a function of the problem's shapes alone, never of how a
kernel tiles it, so a kernel that is redesigned, or fused into another,
is held to the same count.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32,
989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# PatchMatch tile sweep (K1): candidates per pixel per sweep (4 own, 16
# propagated, 12 local and 4 global random), and the smallest side of a
# level the tile path runs on.
K1_CANDIDATES = 36
K1_MIN_SIDE = 128
# Levels whose A side passes this many pixels run this many more sweeps.
K1_BOOST_AREA = 4 * 1024 * 1024
K1_BOOST_SWEEPS = 2


def k1_flop_per_candidate(n_fine: int, n_coarse: int, patch: int,
                          coarse_patch: int) -> int:
    """FLOP to score one candidate at one pixel: per channel a
    difference, its square and the add (3), per window tap of each
    separable window sum 4 (two passes of multiply and add), and one add
    per window group."""
    flop = 3 * (n_fine + n_coarse) + 4 * patch + 1
    if n_coarse:
        flop += 4 * coarse_patch + 1
    return flop


def k1_sweep_work(h: int, w: int, ha: int, wa: int, frames: int,
                  has_coarse: bool, patch: int = 5, coarse_patch: int = 3,
                  n_src: int = 1, n_flt: int = 1) -> Tuple[float, float]:
    """(FLOP, bytes) one sweep over `frames` B frames of h x w against an
    ha x wa A needs: every pixel scores K1_CANDIDATES candidates; the A
    planes are read once, each frame's B planes once, and each frame's
    field and distance (3 x 4 bytes a pixel) read and written once.  The
    coarse pair is counted at its own (half) resolution."""
    n_fine = n_src + n_flt
    n_coarse = n_fine if has_coarse else 0
    flops = (float(frames) * h * w * K1_CANDIDATES
             * k1_flop_per_candidate(n_fine, n_coarse, patch, coarse_patch))
    coarse_px = lambda y, x: -(-y // 2) * -(-x // 2)  # noqa: E731
    a_bytes = 4.0 * (n_fine * ha * wa + n_coarse * coarse_px(ha, wa))
    b_bytes = 4.0 * frames * (n_fine * h * w + n_coarse * coarse_px(h, w))
    state = 2 * 12.0 * frames * h * w
    return flops, a_bytes + b_bytes + state


def level_shapes(size_b: Tuple[int, int], size_a: Tuple[int, int],
                 levels: int) -> List[Tuple[int, int, int, int]]:
    """(h, w, ha, wa) of each level, finest first (stride-2 pyramids)."""
    out = []
    h, w = size_b
    ha, wa = size_a
    for _ in range(levels):
        out.append((h, w, ha, wa))
        h, w, ha, wa = -(-h // 2), -(-w // 2), -(-ha // 2), -(-wa // 2)
    return out


def k1_bound_s(shapes: Iterable[Tuple[int, int, int, int]], frames: int,
               em_iters: int, pm_iters: int, patch: int = 5,
               coarse_patch: int = 3) -> Dict[str, float]:
    """The least time K1's sweeps of one run take on the H100: per sweep
    the larger of its FLOP at PEAK_FP32_FLOPS and its bytes at
    PEAK_BYTES, summed over the sweeps of every tile level (sides >=
    K1_MIN_SIDE); with the FLOP, bytes and sweeps counted."""
    shapes = list(shapes)
    total = flops_all = bytes_all = 0.0
    sweeps_all = 0
    for i, (h, w, ha, wa) in enumerate(shapes):
        if min(h, w) < K1_MIN_SIDE:
            continue
        has_coarse = i < len(shapes) - 1
        flops, nbytes = k1_sweep_work(h, w, ha, wa, frames, has_coarse,
                                      patch, coarse_patch)
        sweeps = em_iters * (pm_iters + (K1_BOOST_SWEEPS
                                         if ha * wa > K1_BOOST_AREA else 0))
        total += sweeps * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        flops_all += sweeps * flops
        bytes_all += sweeps * nbytes
        sweeps_all += sweeps
    return {"bound_s": total, "flops": flops_all, "bytes": bytes_all,
            "sweeps": sweeps_all}


def k2_bound_s(n_b: int, n_a: int, d_pad: int, bf16: bool = False) -> float:
    """Exact-NN search (K2): float32 as three TF32 passes of 2·N_B·N_A·D
    at PEAK_TF32_FLOPS, or one bf16 pass of 2·N_B·N_A·68 at
    PEAK_BF16_FLOPS."""
    if bf16:
        return 2.0 * n_b * n_a * d_pad / PEAK_BF16_FLOPS
    return 3.0 * 2.0 * n_b * n_a * d_pad / PEAK_TF32_FLOPS


def k3_bound_s(rows: int, row_bytes: int) -> float:
    """Row gather (K3): M·(2·row + 8) bytes at PEAK_BYTES."""
    return rows * (2.0 * row_bytes + 8.0) / PEAK_BYTES

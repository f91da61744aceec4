"""K1's share of its roofline (%) at steerable width: the least time the
profiled unit's PatchMatch tile sweeps need on the H100 over the device
time of the K1 kernels (`tile_sweep` in the name) in its trace.

The least time is summed per sweep as in `workcount.k1_bound_s` (the
larger of the sweep's FLOP at the FP32 peak and its bytes at the HBM
peak, over the tile levels, `em_iters` x (`pm_iters` plus the boost
sweeps of a large A)), with each sweep's work counted at the steerable
channel count: `workcount.k1_sweep_work(..., n_src=1 + n_orientations,
n_flt=1)`.  Everything comes from the cell's files: the configuration's
`synth` keys, its level count as the steerable reference works it out,
and the mix's `size` (square A, A' and B); nothing from the program.
"""

from portbench import reference, reference_steerable, workcount

K1_NAME = "tile_sweep"


def bound(synth, side: int, frames: int):
    """(least seconds, FLOP, bytes, sweeps) of one unit's K1 sweeps."""
    spec = reference_steerable.Spec.from_synth(synth)
    levels = reference.n_levels(spec, (side, side), (side, side))
    shapes = workcount.level_shapes((side, side), (side, side), levels)
    total = flops_all = bytes_all = 0.0
    sweeps_all = 0
    for i, (h, w, ha, wa) in enumerate(shapes):
        if min(h, w) < workcount.K1_MIN_SIDE:
            continue
        flops, nbytes = workcount.k1_sweep_work(
            h, w, ha, wa, frames, i < len(shapes) - 1, spec.patch_size,
            spec.coarse_patch_size, n_src=1 + spec.n_orientations, n_flt=1)
        sweeps = spec.em_iters * (
            synth["pm_iters"] + (workcount.K1_BOOST_SWEEPS
                                 if ha * wa > workcount.K1_BOOST_AREA
                                 else 0))
        total += sweeps * max(flops / workcount.PEAK_FP32_FLOPS,
                              nbytes / workcount.PEAK_BYTES)
        flops_all += sweeps * flops
        bytes_all += sweeps * nbytes
        sweeps_all += sweeps
    return total, flops_all, bytes_all, sweeps_all


def read(ctx):
    traced = ctx["traced"]
    k1_ms = sum(ms for name, ms in traced["trace"]["ops"].items()
                if K1_NAME in name)
    if k1_ms <= 0.0:
        return None
    least_s = bound(ctx["cell"].config["synth"],
                    int(ctx["cell"].mix["size"]),
                    traced["profiled_frames"])[0]
    return 100.0 * least_s * 1e3 / k1_ms

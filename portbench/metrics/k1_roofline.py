"""K1's share of its roofline (%): the least time the profiled unit's
PatchMatch tile sweeps need on the H100 over the device time of the K1
kernels (`tile_sweep` in the name) in its trace.

The least time is `workcount.k1_bound_s` of the unit's level shapes,
frames, windows and sweeps, all taken from the cell's files: the
configuration's `synth` keys, its level count as the reference works it
out (`reference.n_levels`), and the mix's `size` (square A, A' and B).
Nothing of it comes from the program, so a K1 that is redesigned or
fused away is held to the same count.
"""

from portbench import reference, workcount

K1_NAME = "tile_sweep"


def read(ctx):
    traced = ctx["traced"]
    k1_ms = sum(ms for name, ms in traced["trace"]["ops"].items()
                if K1_NAME in name)
    if k1_ms <= 0.0:
        return None
    synth = ctx["cell"].config["synth"]
    side = int(ctx["cell"].mix["size"])
    spec = reference.Spec.from_synth(synth)
    levels = reference.n_levels(spec, (side, side), (side, side))
    shapes = workcount.level_shapes((side, side), (side, side), levels)
    bound = workcount.k1_bound_s(shapes, traced["profiled_frames"],
                                 synth["em_iters"], synth["pm_iters"],
                                 synth["patch_size"],
                                 synth["coarse_patch_size"])
    return 100.0 * bound["bound_s"] * 1e3 / k1_ms

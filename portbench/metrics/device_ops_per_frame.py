"""Device events (kernels, copies, memsets) per frame in the profiled
unit's trace."""


def read(ctx):
    traced = ctx["traced"]
    n = traced["trace"]["n_device"]
    if not n:
        return None
    return n / traced["profiled_frames"]

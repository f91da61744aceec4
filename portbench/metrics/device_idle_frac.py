"""The device's idle share of the wall: 1 - (device-busy ms per frame,
the union of the device events in the profiled unit's trace) / (wall ms
per frame of the run's window, profiler off)."""


def read(ctx):
    busy = ctx["traced"]["trace"]["busy_ms"]
    win = ctx["window"]
    if busy is None or not win["frames"]:
        return None
    wall_ms_per_frame = 1e3 * win["window_s"] / win["frames"]
    return 1.0 - (busy / ctx["traced"]["profiled_frames"]) / wall_ms_per_frame

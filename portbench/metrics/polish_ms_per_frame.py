"""Polish device time per frame (ms): the sum of the device intervals of
the program's `polish` spans (the sequential polish sweeps of the tile
path, one span a frame and EM step that polishes) over the traced unit,
divided by the unit's frames.  None where the spans carry no device
interval (a CPU run, or a program without `polish` spans)."""


def read(ctx):
    traced = ctx["traced"]
    ms = [getattr(s, "device_ms", None)
          for s in traced["tracer"].find("polish")]
    if not ms or None in ms:
        return None
    return sum(ms) / traced["span_frames"]

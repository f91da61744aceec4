"""Steerable-bank device time per frame (ms): the sum of the device
intervals of the program's `steer` spans (the oriented-filter bank of
the prologue, one span for A's pyramid and one for B's) over the traced
unit, divided by the unit's frames.  None where the spans carry no
device interval (a CPU run) or where the program opens no `steer` span."""


def read(ctx):
    traced = ctx["traced"]
    ms = [getattr(s, "device_ms", None)
          for s in traced["tracer"].find("steer")]
    if not ms or None in ms:
        return None
    return sum(ms) / traced["span_frames"]

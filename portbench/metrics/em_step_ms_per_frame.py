"""EM-step device time per frame (ms): the sum of the device intervals
(start event to end event, no sync inside) of the program's `em_iter`
spans over the traced unit, divided by the unit's frames.  None where
the spans carry no device interval (a CPU run, or a program whose EM
steps are not timed spans)."""


def read(ctx):
    traced = ctx["traced"]
    ms = [getattr(s, "device_ms", None)
          for s in traced["tracer"].find("em_iter")]
    if not ms or None in ms:
        return None
    return sum(ms) / traced["span_frames"]

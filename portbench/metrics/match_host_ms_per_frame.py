"""The match's host issue time per frame (ms): the sum of the host
clock from open to close of the program's `match` spans (no device sync
inside, so the time the host took to issue the match's work) over the
traced unit, divided by the unit's frames.  Read where the spans also
carry device intervals, so both halves of the comparison are there;
None otherwise (a CPU run, or a program whose match is not timed)."""


def read(ctx):
    traced = ctx["traced"]
    spans = traced["tracer"].find("match")
    if not spans or any(getattr(s, "device_ms", None) is None
                        for s in spans):
        return None
    return sum(s.host_ms for s in spans) / traced["span_frames"]

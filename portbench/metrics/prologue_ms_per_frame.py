"""Prologue wall per frame (ms): the program's `prologue` record (colour
conversion, remap, pyramids; it ends in one device sync) over the
traced unit, divided by the unit's frames."""


def read(ctx):
    traced = ctx["traced"]
    spans = traced["tracer"].find("prologue")
    if not spans:
        return None
    return sum(s.wall_ms for s in spans) / traced["span_frames"]

"""Level-loop wall per frame (ms): the sum of the program's `level` spans
(each ends in one device sync) over the traced unit, divided by the
unit's frames."""


def read(ctx):
    traced = ctx["traced"]
    spans = traced["tracer"].find("level")
    if not spans:
        return None
    return sum(s.wall_ms for s in spans) / traced["span_frames"]

"""B' frames returned over the whole window's seconds (frames/s)."""


def read(ctx):
    win = ctx["window"]
    if not win["frames"]:
        return None
    return win["frames"] / win["window_s"]

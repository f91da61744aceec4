"""The allocator's peak over the window (GiB), reset after the warm-up:
`torch.cuda.max_memory_allocated()` as the harness read it when the
window closed (None on the CPU)."""


def read(ctx):
    peak = ctx["peak_bytes"]
    return None if peak is None else peak / float(1 << 30)

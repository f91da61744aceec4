"""Set-up (s): process start to the window's start: imports, the CUDA
context, the kernel libraries, inputs made from the seed, the warm-up."""


def read(ctx):
    return ctx["setup_s"]

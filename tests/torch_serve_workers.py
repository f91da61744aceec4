"""Follower functions of the multi-rank serving tests
(tests/test_torch_serve_multi.py).

`parallel.mesh.start_world` starts followers with the "spawn" start
method, so each imports the function it runs by name: they live here,
in a module that imports only torch and the port, never JAX or a test
module that imports it."""

import torch

from image_analogies_tpu_torch.runtime import faults
from image_analogies_tpu_torch.serving.ranks import follow


def follower(fault_plan=None) -> None:
    """A serving follower on one intra-op thread, with `fault_plan`
    armed in this rank alone."""
    torch.set_num_threads(1)
    if fault_plan:
        faults.set_fault_plan(fault_plan)
    follow()


def exit_at_once() -> None:
    """A follower that dies as soon as it has joined (exit code 3)."""
    import os

    os._exit(3)


def exit_when(flag: str, timeout_s: float = 120.0) -> None:
    """A follower that dies (exit code 3) once the file `flag` exists,
    at a moment its test chooses, without following."""
    import os
    import time

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(flag) and time.monotonic() < deadline:
        time.sleep(0.02)
    os._exit(3)


def meet() -> None:
    """A follower that meets rank 0 at one barrier of the default group,
    then leaves."""
    import torch.distributed as dist

    dist.barrier()

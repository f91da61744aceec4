"""Device meshes over `torch.distributed`, and the launcher of ranks.

The reference is single-controller: one process holds a
`jax.sharding.Mesh` and `shard_map` places each shard's work.  The port
is SPMD: one process per rank, every rank runs the same runner on its
own shard, and the cross-rank traffic is explicit `torch.distributed`
calls at named sites (parallel/comms.py).  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis
names ("batch", "space", "bands", "slabs").

The backend follows the tensors' device, chosen by the caller: NCCL for
CUDA tensors, gloo for CPU tensors (several CPU processes stand in for
the reference's 8 virtual devices).  `device_type` defaults to "cuda",
as the port's entry points do, and a CUDA mesh or launch raises on a
machine without a card; the CPU is asked for with device_type="cpu".
Nothing switches backend or device when something fails.

`spawn` starts `n` ranks (start method "spawn", rendezvous on a free
127.0.0.1 port, a collective timeout so a hung rank fails instead of
hanging its caller), runs a function on each and returns rank 0's
result, re-raising any rank's exception.  `start_world` is for a
command that does not finish, the serving daemon: the calling process
becomes rank 0 of a world that lives as long as it does, its other ranks
child processes that run a function until it returns (no deadline; they
end on their own when rank 0 is gone), so the caller's pid, lockfile and
signals keep their meaning.  `initialize_multihost` joins a `torchrun`
world from its environment.  The reference's `shard_map` version shim
has no counterpart: there is no shard_map.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import socket
import threading
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
SPACE_AXIS = "space"
BANDS_AXIS = "bands"
SLABS_AXIS = "slabs"

# A collective that waits longer than this fails its rank (gloo and
# NCCL both honour the process group's timeout).
DEFAULT_TIMEOUT_S = 300.0

log = logging.getLogger("image_analogies_tpu_torch")


def backend_for(device_type: str) -> str:
    """The process-group backend for tensors of `device_type`."""
    return "nccl" if device_type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _init_world(backend: str, world_size: int, rank: int, port: int,
                timeout_s: float) -> None:
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _leave_world() -> None:
    """Destroy the default group, if this process has one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _require_device(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh was asked for, but torch.cuda.is_available() is "
            "False; pass device_type='cpu' for gloo ranks on the CPU")


def world_size() -> int:
    """Ranks of the current world (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the current world (0 when none)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (BATCH_AXIS,),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: str = "cuda",
):
    """A `DeviceMesh` over the first `n_devices` ranks of the world
    (default: all), `shape` splitting them over named axes, e.g.
    shape=(2, 2), axis_names=("bands", "slabs").  With no world
    initialized, a one-rank world of `backend_for(device_type)` is
    started on 127.0.0.1, so a single process runs the runners as a
    mesh of one.  Raises when more ranks are asked for than the world
    has, and for a "cuda" mesh without a card."""
    from torch.distributed.device_mesh import DeviceMesh

    _require_device(device_type)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1")
        _init_world(backend_for(device_type), 1, 0, _free_port(),
                    DEFAULT_TIMEOUT_S)
    have = dist.get_world_size()
    n = have if n_devices is None else int(n_devices)
    if n > have or n < 1:
        raise ValueError(f"requested {n} devices, have {have}")
    shape = tuple(shape) if shape is not None else (n,)
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"{len(shape)} mesh axes named {tuple(axis_names)}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join a multi-process world: with explicit arguments at
    `tcp://coordinator_address`, else from a `torchrun` environment
    (`env://`: WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).  Returns
    True when a world was joined (or already was), False when there is
    no cluster environment (a single process: the runners then make a
    mesh of one).  An explicit spec that fails raises."""
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address or num_processes or process_id is not None:
        if not (coordinator_address and num_processes
                and process_id is not None):
            raise ValueError(
                "an explicit world needs coordinator_address, "
                "num_processes and process_id"
            )
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timeout,
        )
        return True
    env = os.environ
    if all(k in env for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR",
                              "MASTER_PORT")):
        if int(env["WORLD_SIZE"]) <= 1:
            return False
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    log.info("no cluster environment detected; running single-process")
    return False


def make_hybrid_mesh(dcn_axis: str = BATCH_AXIS,
                     ici_axis: str = SPACE_AXIS, device_type: str = "cuda"):
    """A 2-D mesh with the slower axis outermost: (hosts, ranks per
    host) when `torchrun`'s LOCAL_WORLD_SIZE says the world spans
    several hosts (frames across hosts, halos inside one), else
    (1, world) — the reference's layout recipe, with hosts in place of
    TPU slices."""
    n = world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n)
    if per_host < n and n % per_host == 0:
        shape = (n // per_host, per_host)
    else:
        shape = (1, n)
    return make_mesh(n, axis_names=(dcn_axis, ici_axis), shape=shape,
                     device_type=device_type)


# ---------------------------------------------------------------------------
# Axis helpers: the reference's shardings, as what one rank holds.


def axis_group(mesh, axis: str):
    """The process group of `axis` that this rank belongs to."""
    return mesh.get_group(mesh_dim=axis)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(mesh_dim=axis))


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's (a mesh over fewer ranks
    than the world leaves the others out)."""
    return mesh.get_coordinate() is not None


def batch_sharding(x: torch.Tensor, mesh, axis: str = BATCH_AXIS):
    """This rank's block of `x`'s leading axis, split evenly over
    `axis` (the reference's `NamedSharding(mesh, P(axis))`)."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split over "
                         f"{n} ranks")
    per = x.shape[0] // n
    return x[r * per : (r + 1) * per]


def replicated(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole tensor: every rank holds it (`P()`)."""
    return x


# ---------------------------------------------------------------------------
# The launcher.


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple):
        return tuple(_to_cpu(o) for o in obj)
    if isinstance(obj, list):
        return [_to_cpu(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, fn: Callable, n: int, backend: str,
               device_type: str, devices, port: int, args: tuple,
               queue, timeout_s: float) -> None:
    """One spawned rank: join the world, run `fn(*args)`, report."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(devices[rank] if devices else rank)
        _init_world(backend, n, rank, port, timeout_s)
        try:
            out = fn(*args)
            # Pickled to bytes here: a tensor put on the queue as it is
            # travels as a shared-memory handle, gone once this process
            # exits.
            queue.put((rank, "ok",
                       pickle.dumps(_to_cpu(out)) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, "error", traceback.format_exc()))


def spawn(fn: Callable, n: int, backend: Optional[str] = None,
          device_type: str = "cuda", devices=None, args: tuple = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run `fn(*args)` on `n` new ranks of a fresh world and return rank
    0's result (tensors moved to the CPU).  `fn` must be importable by
    name (start method "spawn").  Rank r runs on `cuda:devices[r]`
    (default `cuda:r`) when `device_type` is "cuda"; the backend
    defaults to `backend_for(device_type)`.  Any rank's exception, or a
    rank that dies without reporting, raises here after every rank has
    stopped; "cuda" ranks without a card raise before any starts."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"{n} ranks")
    _require_device(device_type)
    backend = backend or backend_for(device_type)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main,
                    args=(r, fn, n, backend, device_type, devices, port,
                          args, queue, timeout_s),
                    name=f"ia-rank-{r}")
        for r in range(n)
    ]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + 4 * timeout_s
    try:
        while len(results) + len(errors) < n:
            if not queue.empty():
                rank, status, payload = queue.get()
                (results if status == "ok" else errors)[rank] = payload
                if errors:
                    break
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and p.exitcode != 0
                    and r not in results and r not in errors]
            if dead and queue.empty():
                for r in dead:
                    errors[r] = (f"rank {r} exited with code "
                                 f"{procs[r].exitcode} without reporting")
                break
            if time.monotonic() > deadline:
                errors[-1] = f"ranks did not finish within {4 * timeout_s} s"
                break
            time.sleep(0.02)
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        detail = "\n".join(f"--- rank {r} ---\n{tb}"
                           for r, tb in sorted(errors.items()))
        raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n{detail}")
    return pickle.loads(results[0])


# ---------------------------------------------------------------------------
# A world that lives as long as its rank 0.

# How often a follower checks that rank 0 still exists, and how often
# rank 0 checks its followers (seconds).
_WATCH_S = 0.2


def _watch_parent(parent_pid: int) -> None:
    """End this process when its parent, rank 0, is gone (the parent's
    death re-parents the child): a follower stuck in a collective must
    not hold its card after its rank 0 was killed."""
    def loop():
        while os.getppid() == parent_pid:
            time.sleep(_WATCH_S)
        os._exit(1)

    threading.Thread(target=loop, name="ia-rank-parent-watch",
                     daemon=True).start()


def _follower_main(rank: int, fn: Callable, n: int, backend: str,
                   device_type: str, devices, port: int, args: tuple,
                   timeout_s: float, parent_pid: int) -> None:
    """One follower of `start_world`: join the world, run `fn(*args)`,
    leave.  An exception ends the process with a nonzero code."""
    _watch_parent(parent_pid)
    if device_type == "cuda":
        torch.cuda.set_device(devices[rank] if devices else rank)
    _init_world(backend, n, rank, port, timeout_s)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


class Followers:
    """Ranks 1..n-1 of a world whose rank 0 is this process: child
    processes started by `start_world` (none for a world of one, or
    when the world was joined under `torchrun`, whose ranks are not
    children)."""

    def __init__(self, procs=()):
        self.procs = list(procs)
        self._quiet = threading.Event()

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def dead(self) -> list:
        """(rank, exit code) of every follower that has ended."""
        return [(r, p.exitcode) for r, p in enumerate(self.procs, start=1)
                if p.exitcode is not None]

    def watch(self, on_exit: Callable[[int, Optional[int]], None]) -> None:
        """Call `on_exit(rank, exitcode)` from a watcher thread when a
        follower ends before `join` was asked for."""
        if not self.procs:
            return

        def loop():
            while not self._quiet.wait(_WATCH_S):
                dead = self.dead()
                if dead:
                    if not self._quiet.is_set():
                        on_exit(*dead[0])
                    return

        threading.Thread(target=loop, name="ia-rank-watch",
                         daemon=True).start()

    def join(self, timeout_s: float = 60.0) -> list:
        """Wait for every follower to end (killing one that outlives
        `timeout_s`); returns their exit codes, rank 1 first."""
        self._quiet.set()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        return [p.exitcode for p in self.procs]

    def kill(self) -> None:
        self._quiet.set()
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()

    def guard(self, fn: Callable[[], Any], what: str,
              timeout_s: float = 0.0,
              undo: Optional[Callable[[], None]] = None) -> Any:
        """`fn()`, run on a helper thread while this one watches the
        followers.  When one exits before `fn` returns (or as `fn`
        fails, since a dying peer's sockets close before its exit is
        seen), this raises a RuntimeError naming it at once and kills
        the others, instead of leaving rank 0 in a collective until its
        timeout.  With `undo`, the abandoned call is first given
        `timeout_s` (what bounds its collectives) to end, and `undo()`
        then reverses what it did (a default group formed after the
        follower's exit, say), so a failed start leaves nothing behind."""
        if not self.procs:
            return fn()
        box: dict = {}

        def run():
            try:
                box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["error"] = e

        t = threading.Thread(target=run, name="ia-rank-0-guarded",
                             daemon=True)
        t.start()
        while t.is_alive():
            t.join(_WATCH_S)
            if t.is_alive() and self.dead():
                break
        if "error" in box:
            for p in self.procs:
                p.join(_WATCH_S)
        dead = self.dead()
        if not dead:
            if "error" in box:
                raise box["error"]
            return box.get("out")
        self.kill()
        if undo is not None:
            t.join(timeout_s)
            if t.is_alive():
                log.error("%s: rank 0's call did not end within %.0f s",
                          what, timeout_s)
            else:
                undo()
        raise RuntimeError(f"{what}: " + ", ".join(
            f"rank {r} exited with code {c}" for r, c in dead)) \
            from box.get("error")


def start_world(n: int, fn: Callable, args: tuple = (),
                backend: Optional[str] = None, device_type: str = "cuda",
                devices=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Followers:
    """Make this process rank 0 of a fresh world of `n` ranks that lasts
    until it ends: ranks 1..n-1 are child processes (start method
    "spawn") that join the world, run `fn(*args)` and leave when it
    returns; rank 0 joins here and returns their `Followers`.  Rank r
    runs on `cuda:devices[r]` (default `cuda:r`) when `device_type` is
    "cuda" (rank 0's device is set here).  A follower that exits before
    the world forms raises here at once, the others are killed and this
    process is left with no default group; `timeout_s` bounds the
    forming and is the default group's collective timeout.  Each
    follower ends itself when this process is gone.  `fn` must be
    importable by name."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"{n} ranks")
    _require_device(device_type)
    backend = backend or backend_for(device_type)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_follower_main,
                    args=(r, fn, n, backend, device_type, devices, port,
                          args, timeout_s, os.getpid()),
                    name=f"ia-rank-{r}")
        for r in range(1, n)
    ]
    for p in procs:
        p.start()
    followers = Followers(procs)
    if device_type == "cuda":
        torch.cuda.set_device(devices[0] if devices else 0)
    try:
        followers.guard(
            lambda: _init_world(backend, n, 0, port, timeout_s),
            "the world did not form", timeout_s, _leave_world)
    except BaseException:
        followers.kill()
        raise
    return followers

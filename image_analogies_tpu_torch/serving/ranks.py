"""Multi-device serving: rank 0 serves, the other ranks follow its
dispatches (`serve --n-devices N`).

The reference is single-controller: its one daemon process holds a
mesh and every dispatch is `synthesize_batch(..., mesh)` over all of
its devices.  On `torch.distributed` every rank is a process and every
rank must issue the same collectives in the same order, so the port
needs what the reference never had: a channel through which the ranks
other than 0 (the followers) learn of each dispatch and run it in step
with rank 0.  This module is that channel.

World.  The `serve` process is rank 0 (`parallel.mesh.start_world`):
its pid, the state dir's lockfile, SIGTERM (drain) and SIGKILL
(takeover) keep the meaning they have for one process.  The followers
are its children; each ends itself when rank 0 is gone (a watch of its
parent, and the store below failing), so no orphan holds a card after a
SIGKILL.  Under `torchrun` the world is joined instead, rank 0 serves
and the others follow.  Rank 0 alone does the serving work (HTTP,
admission, journal, queue, batching, cache accounting, demux,
telemetry); the followers hold the style pair and run dispatches.

Three channels, made at start-up (`ServingMesh`, `follow`):
  - the store: a TCPStore hosted by rank 0.  Each message's header is
    one key, `ia-serve/<seq>`, a pickled dict: the kind ("dispatch",
    "retry" with `resume_from`, "stop"), the sequence number, the data
    group's epoch, the frame stack's shape (its first axis is the
    grain), the bucket-centre `b_stats`, the config with the dispatch's
    checkpoint dir (all ranks share one host and read it on a retry)
    and the process-wide engine modes (`config.engine_modes()`, whole);
  - the control group: gloo, CPU tensors.  It carries the frames (one
    broadcast after the header) and each attempt's outcome (an
    all_gather of ok, K1 launches and peak device bytes per rank);
  - the data group: NCCL on cards (gloo on the CPU, or for ranks that
    share one card), the runner's per-level checkpoint gathers and the
    output gather, through a `DeviceMesh` with the "batch" axis.
Every rank runs `synthesize_batch(..., mesh=, frame_indices=[0] *
grain, _b_stats=)` on the same inputs, as the single daemon does, so a
frame's answer is the same on any number of ranks (the isolation
contract, serving/daemon.py); rank 0 keeps the gathered stack.

An idle daemon never times out: a follower waits for the next header in
the store (`IDLE_POLL_S` a wait, then again), never inside a collective,
and a failed wait means rank 0 is gone, which ends the follower.  So the
groups keep finite timeouts, and a rank that is wedged fails the world
instead of hanging it.  (A heartbeat would add a thread on rank 0 and
contend with dispatches for the channel; a group without a timeout
would let one wedged rank hang every other.)

One thread issues on each group: `ServingMesh.run` holds a lock from
the header to the outcome, so warmup's concurrent shapes, the
dispatcher's pipelined batches and a supervisor retry reach the
followers one at a time, in one order.  Session frames never use the
channel: they run solo on rank 0, as the reference's do on a solo mesh.

Failure.  A fault on one rank (an injected fault, the supervisor's abort
token, an error) ends that rank's attempt while the others wait in a
data collective; gloo cannot be interrupted (destroying a group on one
side does not wake the other), so the waiting ranks leave when the data
group's timeout (`timeout_s`, the daemon's --dispatch-deadline-s, else
`DEFAULT_TIMEOUT_S`) expires.  The control group's timeout is twice
that, so every rank still reports.  Any rank's failure fails the attempt
on every rank (`RankFailed`, or rank 0's own exception) and bumps the
epoch: the next header tells every rank to build a new data group
before its first collective, so a retry never issues on a group where a
dead attempt's peer may still wait.  The supervisor then retries with
`resume_from` (a heal, bit-identical) or gives the batch up (500).
A rank that is gone (a follower's exit seen by rank 0's watch within
0.2 s, or a collective or the store failing, which gloo reports at
once) makes the world lost (`WorldLost`): the supervisor does not retry
it, the batch in flight and every later sessionless batch are answered
503 with Retry-After, /healthz turns 503, and the daemon drains,
keeping their journal entries, and exits nonzero, for `serve
--takeover` to replay.  On gloo that happens at once; on NCCL a rank
waiting in a collective with a dead peer waits out the data group's
timeout first.  Nothing carries on as fewer ranks, or on the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import engine_modes, set_engine_modes
from ..parallel.mesh import BATCH_AXIS, DEFAULT_TIMEOUT_S
from ..runtime.supervisor import AttemptFatal

DISPATCH, RETRY, STOP = "dispatch", "retry", "stop"
# A follower's wait for the next header (seconds).  The wait returns as
# soon as the key is set and raises as soon as rank 0's store is gone;
# its length only sets how often an idle follower wakes (and c10d logs
# the wait's timeout).
IDLE_POLL_S = 600.0
_KEY = "ia-serve/{}"

_LOG = logging.getLogger("image_analogies_tpu_torch")


class WorldLost(AttemptFatal):
    """A rank is gone or stopped answering: the world runs no further
    dispatch (the daemon drains; `serve --takeover` replays)."""


class RankFailed(RuntimeError):
    """An attempt failed on a follower while rank 0's finished: every
    rank gave the attempt up, and the next one runs on a new data
    group."""


def _k1_launches() -> int:
    from ..kernels import patchmatch_tile as pt

    return pt.launches.count + pt.launches_int8.count


def _peak_bytes(device_type: str) -> int:
    return (int(torch.cuda.max_memory_allocated())
            if device_type == "cuda" else 0)


class _Groups:
    """What every rank holds: the store, the control group, the data
    group with its "batch" mesh, and the data group's epoch.  `store`
    is rank 0's own (the server); the others connect to it."""

    def __init__(self, setup: Dict[str, Any], store=None):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device_type = setup["device_type"]
        self.timeout_s = float(setup["timeout_s"])
        self.backend = dist.get_backend()
        host, port = setup["store"]
        self.store = store or dist.TCPStore(
            host, port, is_master=False,
            timeout=datetime.timedelta(seconds=self.timeout_s))
        self.ctrl = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=2 * self.timeout_s))
        self.data = self.mesh = None
        self.built = -1
        self.rebuild(0)

    def rebuild(self, epoch: int) -> None:
        """A new data group (collective over the world: every rank calls
        it at the same header)."""
        from torch.distributed.device_mesh import DeviceMesh

        if self.data is not None:
            dist.destroy_process_group(self.data)
        self.data = dist.new_group(
            backend=self.backend,
            timeout=datetime.timedelta(seconds=self.timeout_s))
        self.mesh = DeviceMesh.from_group(self.data, self.device_type,
                                          mesh_dim_names=(BATCH_AXIS,))
        self.built = epoch

    def exchange(self, ok: bool, launches: int) -> np.ndarray:
        """Every rank's (ok, K1 launches, peak device bytes) of this
        attempt, rank 0 first."""
        t = torch.tensor([int(ok), launches, _peak_bytes(self.device_type)],
                         dtype=torch.int64)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.ctrl)
        return torch.stack(parts).numpy()

    def next_header(self, seq: int) -> Dict[str, Any]:
        """The follower's wait for header `seq`: a store poll, so an
        idle follower sits in no collective.  Raises when rank 0's store
        is gone."""
        key = _KEY.format(seq)
        while True:
            try:
                self.store.wait([key],
                                datetime.timedelta(seconds=IDLE_POLL_S))
                break
            except RuntimeError:
                if self.store.check([key]):  # raises when rank 0 is gone
                    break
        return pickle.loads(self.store.get(key))


class ServingMesh:
    """Rank 0's handle on a serving world (module docstring): `run`
    dispatches one attempt over every rank, `snapshot` reports the
    ranks, `close` stops them.  `followers` is the
    `parallel.mesh.Followers` of `start_world` (empty under `torchrun`,
    or at world size 1); the world must exist.  `timeout_s` is the data
    group's collective timeout (the control group's is twice it)."""

    def __init__(self, followers, a, ap, *, device_type: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if dist.get_rank() != 0:
            raise ValueError("the serving mesh is rank 0's")
        self.followers = followers
        self.a = np.asarray(a, np.float32)
        self.ap = np.asarray(ap, np.float32)
        self.device_type = device_type
        self._device = (torch.cuda.current_device()
                        if device_type == "cuda" else None)
        host = os.environ.get("MASTER_ADDR", "127.0.0.1")
        store = dist.TCPStore(
            host, 0, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=timeout_s))
        setup = {"a": self.a, "ap": self.ap, "timeout_s": timeout_s,
                 "device_type": device_type, "store": (host, store.port)}

        def start():
            if self._device is not None:
                torch.cuda.set_device(self._device)
            dist.broadcast_object_list([setup], src=0)
            return _Groups(setup, store)

        self._g = followers.guard(start, "the serving ranks did not start")
        self.size = self._g.size
        self.backend = self._g.backend
        self._lock = threading.Lock()
        self._seq = 0
        self._epoch = 0
        self._lost_lock = threading.Lock()
        self.lost: Optional[str] = None
        self._listeners: List[Callable[[str], None]] = []
        self._closed = False
        self.k1_launches = [0] * self.size
        self.k1_launches_last = [0] * self.size
        self.peak_bytes = [0] * self.size
        followers.watch(lambda rank, code: self._lose(
            f"rank {rank} exited with code {code}"))

    # ------------------------------------------------------- failure
    def on_lost(self, cb: Callable[[str], None]) -> None:
        """Call `cb(reason)` once, when the world is lost (at once if it
        already is)."""
        with self._lost_lock:
            self._listeners.append(cb)
            lost = self.lost
        if lost is not None:
            cb(lost)

    def _lose(self, reason: str) -> WorldLost:
        with self._lost_lock:
            first = self.lost is None and not self._closed
            if first:
                self.lost = reason
            listeners = list(self._listeners) if first else []
        if first:
            _LOG.error("serving world lost: %s", reason)
            for cb in listeners:
                cb(reason)
        return WorldLost(self.lost or reason)

    # ------------------------------------------------------ dispatch
    def run(self, frames, cfg, *, resume_from: Optional[str] = None,
            b_stats=None, progress=None) -> torch.Tensor:
        """One attempt of one dispatch over every rank: the header and
        the frames to the followers, `synthesize_batch` here with them,
        then every rank's outcome.  Returns the stacked B' (on
        `cfg.device`); raises rank 0's own exception or `RankFailed`
        when any rank failed (the next attempt builds a new data group),
        and `WorldLost` when a rank is gone."""
        from ..parallel.batch import synthesize_batch

        frames = np.ascontiguousarray(frames, np.float32)
        with self._lock:
            if self.lost is not None:
                raise WorldLost(self.lost)
            if self._device is not None:
                # The supervisor's attempt thread: CUDA's current device
                # is per thread.
                torch.cuda.set_device(self._device)
            seq, self._seq = self._seq, self._seq + 1
            key = _KEY.format(seq)
            header = {"kind": RETRY if resume_from else DISPATCH,
                      "seq": seq, "epoch": self._epoch,
                      "shape": tuple(frames.shape), "b_stats": b_stats,
                      "cfg": cfg, "resume_from": resume_from,
                      "modes": engine_modes()}
            try:
                self._g.store.set(key, pickle.dumps(header))
                if self._g.built != self._epoch:
                    self._g.rebuild(self._epoch)
                dist.broadcast(torch.from_numpy(frames), 0,
                               group=self._g.ctrl)
            except RuntimeError as e:
                raise self._lose(f"dispatch {seq} did not reach the "
                                 f"followers: {e}") from e
            k0 = _k1_launches()
            out = error = None
            try:
                out = synthesize_batch(
                    self.a, self.ap, frames, cfg, mesh=self._g.mesh,
                    progress=progress, resume_from=resume_from,
                    frame_indices=[0] * frames.shape[0], _b_stats=b_stats)
            except Exception as e:  # noqa: BLE001 - every rank reports
                error = e
            try:
                outcomes = self._g.exchange(error is None,
                                            _k1_launches() - k0)
            except RuntimeError as e:
                raise self._lose(f"the outcome of dispatch {seq} did not "
                                 f"arrive: {e}") from (error or e)
            finally:
                with contextlib.suppress(RuntimeError):
                    self._g.store.delete_key(key)
            self.k1_launches_last = [int(n) for n in outcomes[:, 1]]
            self.k1_launches = [t + n for t, n in zip(
                self.k1_launches, self.k1_launches_last)]
            self.peak_bytes = [int(b) for b in outcomes[:, 2]]
            failed = [r for r in range(self.size) if not outcomes[r, 0]]
            if failed:
                self._epoch += 1
                if error is not None:
                    raise error
                raise RankFailed(f"dispatch {seq} failed on rank(s) "
                                 f"{failed}")
            return out

    # ------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """The ranks, for GET /serving."""
        return {
            "size": self.size, "backend": self.backend,
            "device_type": self.device_type,
            "follower_pids": self.followers.pids,
            "dispatches": self._seq, "data_group_epoch": self._epoch,
            "lost": self.lost,
            "k1_launches": list(self.k1_launches),
            "k1_launches_last_dispatch": list(self.k1_launches_last),
            "peak_bytes": list(self.peak_bytes),
        }

    # --------------------------------------------------------- close
    def close(self, timeout_s: float = 60.0) -> List[Optional[int]]:
        """Stop the followers and leave the world; returns the followers'
        exit codes (rank 1 first; empty under `torchrun`).  A lost world
        kills its remaining followers."""
        with self._lost_lock:
            self._closed = True
        with self._lock:
            if self.lost is None:
                try:
                    self._g.store.set(_KEY.format(self._seq), pickle.dumps(
                        {"kind": STOP, "seq": self._seq}))
                    # Every rank has read the stop before the store (in
                    # this process) goes.
                    dist.barrier(group=self._g.ctrl)
                    codes = self.followers.join(timeout_s)
                except RuntimeError as e:
                    _LOG.error("serving world stop failed: %s", e)
                    self.followers.kill()
                    codes = [p.exitcode for p in self.followers.procs]
            else:
                self.followers.kill()
                codes = [p.exitcode for p in self.followers.procs]
            dist.destroy_process_group()
        return codes


def follow() -> None:
    """A follower's life (ranks 1..n-1 of a serving world): take the
    style pair from rank 0, then run each dispatch rank 0 announces,
    with it, until it says stop.  Returns after the stop; raises (and so
    ends the process nonzero) when rank 0 is gone."""
    from ..parallel.batch import synthesize_batch

    box: List[Any] = [None]
    dist.broadcast_object_list(box, src=0)
    setup = box[0]
    g = _Groups(setup)
    a, ap = setup["a"], setup["ap"]
    seq = 0
    while True:
        header = g.next_header(seq)
        seq += 1
        if header["kind"] == STOP:
            dist.barrier(group=g.ctrl)
            return
        if header["epoch"] != g.built:
            g.rebuild(header["epoch"])
        frames = torch.empty(header["shape"], dtype=torch.float32)
        dist.broadcast(frames, 0, group=g.ctrl)
        set_engine_modes(header["modes"])
        k0 = _k1_launches()
        ok = True
        try:
            synthesize_batch(
                a, ap, frames.numpy(), header["cfg"], mesh=g.mesh,
                resume_from=header["resume_from"],
                frame_indices=[0] * frames.shape[0],
                _b_stats=header["b_stats"])
        except Exception:  # noqa: BLE001 - reported to rank 0
            _LOG.exception("rank %d: dispatch %d failed", g.rank,
                           header["seq"])
            ok = False
        g.exchange(ok, _k1_launches() - k0)

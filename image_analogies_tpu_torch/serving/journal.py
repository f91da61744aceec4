"""Durable request journal for the serving daemon: the reference's
module, copied, with its record grammar, so each package reads the
other's `journal.jsonl`.

The daemon is a single in-memory process: before this module, a crash
lost every queued/admitted request with nothing on disk to say they
ever existed.  The journal closes that window with a write-ahead
ledger: every ADMITTED request is appended to
``<state-dir>/journal.jsonl`` BEFORE the client's ack/response path
runs, and marked on completion — so the set of acknowledged-but-
unfinished requests is always recoverable from disk, and
``ia-synth serve --takeover <state-dir>`` replays exactly that set
through the successor's normal queue (bit-identical responses via the
per-request PRNG / ``_b_stats`` isolation contract; see
serving/daemon.py).

Record grammar (one JSON object per line):

  {"kind": "req",  "request_id": ..., "ts": ..., "manifest": {...}}
  {"kind": "mark", "request_id": ..., "outcome": "done" | "replayed"
                                                 | "cancelled"}

``manifest`` is the client's parsed request body (shape/dtype/
image_b64/session_id/...), complete enough for
``daemon._frame_from_manifest`` to reconstruct an identical
``ServeRequest`` on replay.  A ``mark`` retires one ``req``:

  - ``done``       — response written by the process that admitted it;
  - ``replayed``   — completed by a successor after takeover;
  - ``cancelled``  — retired without synthesis (client socket gone,
                     deadline already blown).

The ledger invariant the ``check_serving_recovery`` sentinel grades:

  appended == done + replayed + cancelled + pending,   pending >= 0

published as the ``ia_serve_journal_{appended,done,replayed,
cancelled,pending}`` gauges on every append/mark.

Durability mechanics are accesslog.py's, deliberately: one ``os.write``
per line on an O_APPEND descriptor under a lock, size-capped rotation
to ``<path>.1`` with pending-entry compaction (every still-pending
``req`` is re-written into the fresh generation, so no number of
rotations can hide an unretired request from replay; readers walk
``.1`` then live; the port rotates next only once the live file has
doubled past its compacted size, so a pending backlog larger than
``max_bytes`` costs linear rewrites, not one full rewrite a write),
OSError counted on ``.errors`` rather than raised (a full disk degrades durability accounting, not
availability — the ``serve_diskfull`` fault point exercises exactly
this arm).  A crash mid-write loses at most the torn final line;
``read_entries`` skips it and every completed line still replays.

The pid lockfile (``<state-dir>/daemon.lock``) serializes takeover:
acquiring while the named pid is still alive is refused, a stale pid
is reaped.  One state dir == at most one daemon.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .accesslog import read_entries

JOURNAL_FILE = "journal.jsonl"
LOCK_FILE = "daemon.lock"
DEFAULT_MAX_BYTES = 8 * 1024 * 1024

MARK_OUTCOMES = ("done", "replayed", "cancelled")


def journal_path(state_dir: str) -> str:
    return os.path.join(state_dir, JOURNAL_FILE)


class RequestJournal:
    """Write-ahead request ledger with size-capped rotation.

    Opening scans whatever already exists at `path` (both rotation
    generations, torn-line tolerant) and rebuilds the ledger — the
    successor's view of its predecessor's unfinished work.
    """

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 registry=None):
        if max_bytes < 1024:
            raise ValueError(f"max_bytes too small ({max_bytes})")
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.registry = registry
        self.errors = 0
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._size = 0
        # The size past which the next write rotates: max_bytes, or
        # twice the compacted pending set when that is larger.  (The
        # reference rotates at max_bytes alone: with a pending backlog
        # over max_bytes, such as 4 MiB manifests of 1024^2 frames
        # under the 8 MiB default, every write then rewrote the whole
        # backlog, and appends grew quadratic in the backlog.)
        self._rotate_at = self.max_bytes
        # rid -> "req" record for appended-but-unmarked requests, in
        # append order (dict preserves insertion order == replay order).
        self._pending: Dict[str, Dict[str, Any]] = {}
        self.appended = 0
        self.marked: Dict[str, int] = {o: 0 for o in MARK_OUTCOMES}
        self._scan()
        self._publish()

    # -- recovery scan --------------------------------------------------

    def _scan(self) -> None:
        """Rebuild the ledger from disk: count every readable ``req``,
        retire the ones a ``mark`` names.  Marks for requests that
        rotated out of both generations are orphans and ignored — the
        ledger only ever books work it can still see."""
        for rec in read_entries(self.path):
            kind = rec.get("kind")
            rid = rec.get("request_id")
            if not isinstance(rid, str):
                continue
            if kind == "req" and isinstance(rec.get("manifest"), dict):
                if rid not in self._pending:
                    self.appended += 1
                self._pending[rid] = rec
            elif kind == "mark":
                outcome = rec.get("outcome")
                if outcome in MARK_OUTCOMES and rid in self._pending:
                    del self._pending[rid]
                    self.marked[outcome] += 1

    # -- write path -----------------------------------------------------

    def _open(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._size = os.fstat(self._fd).st_size

    def _write(self, record: Dict[str, Any]) -> bool:
        """One line, one os.write; rotate first when it would overflow.
        OSError is counted, never raised (accesslog contract)."""
        from ..runtime.faults import fire as _fault_fire

        line = (json.dumps(record, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
        with self._lock:
            try:
                # serve_diskfull: simulate the write failing at the
                # syscall boundary — the counted-not-raised arm.
                if _fault_fire("serve_diskfull", self._fire_seq()) \
                        == "fail":
                    raise OSError("injected serve_diskfull")
                if self._fd is None:
                    self._open()
                if self._size + len(line) > self._rotate_at and self._size:
                    os.close(self._fd)
                    os.replace(self.path, self.path + ".1")
                    self._fd = None
                    self._open()
                    # Compact: re-write every still-pending entry into
                    # the fresh generation, so a pending request can
                    # never rotate out of the replay set no matter how
                    # many rotations pass (the live file may
                    # transiently exceed max_bytes when the pending
                    # backlog itself is that large).
                    for prec in self._pending.values():
                        pline = (json.dumps(
                            prec, sort_keys=True,
                            separators=(",", ":"),
                        ) + "\n").encode()
                        os.write(self._fd, pline)
                        self._size += len(pline)
                    self._rotate_at = max(self.max_bytes, 2 * self._size)
                os.write(self._fd, line)
                self._size += len(line)
                return True
            except OSError:
                self.errors += 1
                return False

    def _fire_seq(self) -> int:
        # Per-journal write ordinal: the fault-plan key for
        # serve_diskfull ("fail write N counting from 0").
        seq = self.appended + sum(self.marked.values())
        return seq

    def append(self, request_id: str,
               manifest: Dict[str, Any]) -> bool:
        """Journal one admitted request BEFORE its ack path.  Returns
        whether the line hit disk (False == durability degraded, the
        request still serves)."""
        rec = {
            "kind": "req",
            "request_id": str(request_id),
            "ts": round(time.time(), 6),
            "manifest": manifest,
        }
        ok = self._write(rec)
        with self._lock:
            self.appended += 1
            self._pending[str(request_id)] = rec
        self._publish()
        return ok

    def mark(self, request_id: str, outcome: str = "done") -> bool:
        """Retire one journaled request.  Idempotent per rid: only the
        first mark books (duplicate response paths must not unbalance
        the ledger)."""
        if outcome not in MARK_OUTCOMES:
            raise ValueError(
                f"journal outcome {outcome!r} not in {MARK_OUTCOMES}"
            )
        rid = str(request_id)
        with self._lock:
            if rid not in self._pending:
                return False
            del self._pending[rid]
            self.marked[outcome] += 1
        self._write({"kind": "mark", "request_id": rid,
                     "outcome": outcome})
        self._publish()
        return True

    def compact(self) -> int:
        """Rewrite the journal down to its still-pending entries (one
        atomic generation: tmp + replace, then the `.1` rotation file
        is dropped — its retired history is now redundant).  The drain
        path runs this AFTER the session snapshot lands: the pending
        set a takeover successor replays must never be the freshest
        thing on disk while the session snapshot the router was told
        exists is still unwritten, so ordering is sessions first,
        compaction last (a SIGKILL between the two loses only the
        compaction, which the rotation path redoes for free).  Returns
        the number of pending entries kept; OSError is counted, never
        raised (the live journal stays as it was)."""
        with self._lock:
            try:
                tmp = self.path + ".tmp"
                size = 0
                with open(tmp, "wb") as fh:
                    for prec in self._pending.values():
                        pline = (json.dumps(
                            prec, sort_keys=True,
                            separators=(",", ":"),
                        ) + "\n").encode()
                        fh.write(pline)
                        size += len(pline)
                if self._fd is not None:
                    os.close(self._fd)
                    self._fd = None
                os.replace(tmp, self.path)
                self._size = size
                self._rotate_at = max(self.max_bytes, 2 * size)
                try:
                    os.unlink(self.path + ".1")
                except FileNotFoundError:
                    pass
                return len(self._pending)
            except OSError:
                self.errors += 1
                return 0

    # -- read side ------------------------------------------------------

    def pending_entries(self) -> List[Dict[str, Any]]:
        """Appended-but-unretired ``req`` records, oldest first — the
        takeover replay set."""
        with self._lock:
            return list(self._pending.values())

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {"appended": self.appended,
                   "pending": len(self._pending),
                   "errors": self.errors}
            out.update(self.marked)
        return out

    def _publish(self) -> None:
        reg = self.registry
        if reg is None:
            return
        g = reg.gauge(
            "ia_serve_journal",
            "request-journal ledger (appended == done + replayed + "
            "cancelled + pending)",
        )
        for field, value in self.counts().items():
            if field == "errors":
                continue
            g.set(float(value), labels={"field": field})
        # errors are monotone on self — publish as gauge for dumps.
        reg.gauge(
            "ia_serve_journal_errors",
            "journal write errors counted-not-raised",
        ).set(float(self.errors))

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


# -- state-dir pid lock ------------------------------------------------

def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def acquire_lock(state_dir: str, pid: Optional[int] = None) -> str:
    """Claim `state_dir` for this process.  Refuses (RuntimeError) when
    the lockfile names a pid that is still alive — the double-takeover
    guard — and silently reaps a stale lock (dead pid, unreadable
    file).  Returns the lockfile path."""
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, LOCK_FILE)
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                holder = int(fh.read().strip() or "0")
        except (OSError, ValueError):
            holder = 0
        if holder and holder != os.getpid() and _pid_alive(holder):
            raise RuntimeError(
                f"state dir {state_dir!r} is locked by live pid "
                f"{holder} ({path}); refusing takeover"
            )
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(str(pid if pid is not None else os.getpid()))
    os.replace(tmp, path)
    return path


def release_lock(state_dir: str) -> None:
    """Drop the lock if THIS process holds it (a successor's lock is
    never clobbered by a predecessor's late exit)."""
    path = os.path.join(state_dir, LOCK_FILE)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            holder = int(fh.read().strip() or "0")
    except (OSError, ValueError):
        return
    if holder == os.getpid():
        try:
            os.unlink(path)
        except OSError:
            pass

"""Structured access log for the serving daemon (with the
request-scoped tracing in serving/daemon.py): the reference's module,
copied.  On the port a `disk` verdict marks a shape the fleet's warm
tier had sealed (serving/excache.DiskExecCache), not a deserialized
executable.

One JSONL line per finished request — every outcome, including the
ones that never reached the queue (400 rejected) or never left it
(429 shed, 504 timeout) — carrying the request id, session, executable
key + cache verdict (`hit` | `disk` | `miss`: `disk` marks a dispatch
served by a DESERIALIZED executable from the persistent tier, booked
as `restore_ms` rather than `compile_ms` in the phase attribution),
the phase attribution (queue/compile/restore/execute/demux
milliseconds), and byte counts.  This is the flat, grep-able
counterpart to the per-request span tree: the span tree answers "what
happened inside THIS request", the access log answers "which requests
should I look at".

Durability contract:

  - **Atomic append.**  Each line is ONE `os.write` on an O_APPEND
    file descriptor; POSIX appends of this size are not interleaved
    across writers, so concurrent handler threads never shear a line.
    A lock serializes writers anyway (rotation needs it), making the
    syscall-level guarantee a backstop, not the mechanism.
  - **Size-capped rotation.**  When the live file would exceed
    `max_bytes` the writer seals it through a numbered shift chain —
    `.{N-1}→.N … .1→.2`, then live→`.1`, each step one atomic
    `os.replace`, the oldest generation dropping off the end — keeping
    `generations` (default 4) files of history so an incident
    bundle's access-log tail (round 23, telemetry/archive.py) can
    reach back past one rotation.  Readers (`read_entries`, the
    `ia-synth trace` CLI) walk `.N … .1` then the live file, oldest
    first.
  - **Never the hot path's problem.**  `log()` swallows OSError after
    recording it on `self.errors` — a full disk degrades observability,
    not availability.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_MAX_BYTES = 4 * 1024 * 1024
DEFAULT_GENERATIONS = 4


class AccessLog:
    """Append-only JSONL writer with size-capped rotation across
    `generations` numbered history files."""

    def __init__(self, path: str,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 generations: int = DEFAULT_GENERATIONS):
        if max_bytes < 1024:
            raise ValueError(f"max_bytes too small ({max_bytes})")
        if generations < 1:
            raise ValueError(
                f"generations must be >= 1 ({generations})"
            )
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.generations = int(generations)
        self.errors = 0
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._size = 0

    def _open(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._size = os.fstat(self._fd).st_size

    def log(self, entry: Dict[str, Any]) -> None:
        """Serialize and append one record; rotates first when the
        line would push the live file past `max_bytes`."""
        line = (json.dumps(entry, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
        with self._lock:
            try:
                if self._fd is None:
                    self._open()
                if self._size + len(line) > self.max_bytes and self._size:
                    os.close(self._fd)
                    self._fd = None
                    # Shift chain, oldest first: .{N-1}→.N … .1→.2,
                    # live→.1.  Each step is one atomic os.replace, so
                    # a crash mid-shift leaves every line readable in
                    # SOME generation (possibly duplicated by number,
                    # never lost or torn).
                    for i in range(self.generations - 1, 0, -1):
                        src = f"{self.path}.{i}"
                        if os.path.exists(src):
                            os.replace(src, f"{self.path}.{i + 1}")
                    os.replace(self.path, self.path + ".1")
                    self._open()
                os.write(self._fd, line)
                self._size += len(line)
            except OSError:
                self.errors += 1

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


def read_entries(path: str) -> Iterator[Dict[str, Any]]:
    """Yield access-log records oldest-first across every rotation
    generation (`<path>.N … <path>.1` then `<path>`), skipping
    unparseable lines (a crash mid-write loses at most the final
    line; everything readable still reads).  The shift chain keeps
    numbered generations contiguous from 1, so the scan stops at the
    first gap — single-`.1` writers (the round-16 journal) read
    exactly as before."""
    gens = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        gens.append(f"{path}.{i}")
        i += 1
    for p in list(reversed(gens)) + [path]:
        if not os.path.exists(p):
            continue
        with open(p, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def find_request(path: str, request_id: str
                 ) -> Optional[Dict[str, Any]]:
    """The LAST record for `request_id` (retries/duplicates: latest
    wins), or None when the id never hit this log."""
    found = None
    for rec in read_entries(path):
        if rec.get("request_id") == request_id:
            found = rec
    return found


# Lifecycle order of every phase any access record can carry.  A
# REPLICA record (serving/daemon.py) carries the accept..write subset;
# a ROUTER record (serving/router.py) carries pick/proxy/respond.  The
# two sets are disjoint per record, so one ordered tuple serves both
# readers — and the fleet waterfall (serving/fleettrace.py) relies on
# that shared order when it nests a replica's phases inside the
# router's proxy window.  `ingest` (the body's receipt, decode,
# admission and journal append) and `encode` (the answer's payload)
# are the port's: the reference's replica clock starts at enqueue and
# stops before the payload, which left 18 % of a routed 1024^2
# request's wall outside every named phase on an H100 (PERF.md).
# `accept` (the accepted connection's wait for its handler thread) and
# `write` (the answer's write, reported by `GET /request` only: it
# follows the line) close the rest of the replica's wall.
PHASE_ORDER = (
    "pick_ms", "accept_ms", "ingest_ms", "queue_ms", "compile_ms",
    "restore_ms", "execute_ms", "demux_ms", "encode_ms", "write_ms",
    "proxy_ms", "respond_ms",
)


def phase_fields(rec: Dict[str, Any]) -> List[tuple]:
    """(phase, millis) pairs present in one record, in lifecycle
    order — shared by the trace CLI and tools/serve_load.py so the
    committed critical path and the printed waterfall agree."""
    out = []
    for phase in PHASE_ORDER:
        v = rec.get(phase)
        if isinstance(v, (int, float)):
            out.append((phase[:-3], float(v)))
    return out

"""Flight recorder: a bounded in-memory event log flushed to disk the
moment a run dies.

The other telemetry artifacts (`host_spans.json`, `metrics.json`) are
written when a run reaches the telemetry session's exit.  A killed run
would leave nothing; the recorder keeps a ring of the latest span events
and periodic registry snapshots, and flushes them to `flight.json` on

  - SIGTERM / SIGINT (handlers installed by `install()`, main thread
    only; SIGTERM flushes, restores the previous disposition and
    delivers the signal again, so the process dies with the true
    killed-by-SIGTERM status),
  - interpreter exit (`atexit`: sys.exit and uncaught exceptions),
  - the supervisor's watchdog breach and give-up (`flush("watchdog")`,
    `flush("violation")`), and
  - normal session teardown (reason "session-end"), so every
    instrumented run leaves the artifact.

Every flush is a full atomic rewrite (a temporary file and a rename), so
`flight.json` on disk always parses.  The reference's recorder, copied,
with its serving-request accessors (`request_events`, `tree_events`).

Schema (validated by tools/check_report.py `validate_flight`):

    {"schema_version": 1, "kind": "flight", "flushed_on": str,
     "ts": ISO-8601, "n_flushes": int, "capacity": int,
     "n_events_total": int, "dropped_events": int,
     "span_stack": [ ...Tracer.stack_snapshot()... ],
     "events": [{"kind": "open"|"close"|"mark", "name": str,
                 "t": rel-s, "ts": ISO-8601, "attrs": {...},
                 "wall_ms": float|None}, ...],
     "snapshots": [{"t": rel-s, "ts": ISO-8601, "metrics": {...}}, ...],
     "metrics": {...final registry exposition...} | null}
"""

from __future__ import annotations

import atexit
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.progress import _iso_now

FLIGHT_FILE = "flight.json"
FLIGHT_SCHEMA_VERSION = 1

# Default event-ring capacity.  Memory bound: one event record is a
# span name + small attrs dict (~200-500 bytes serialized), so 512
# events plus 8 registry snapshots holds the recorder's resident set
# in the low hundreds of KB; IA_FLIGHT_RING scales the window linearly
# with that bound.
DEFAULT_RING_CAPACITY = 512
RING_CAPACITY_ENV = "IA_FLIGHT_RING"


def resolve_ring_capacity(cli_value: Optional[int] = None) -> int:
    """Event-ring capacity, by precedence: an explicit CLI value (`serve
    --flight-ring`) > IA_FLIGHT_RING > the 512 default.  A malformed or
    non-positive env value falls back to the default (an observability
    knob must never be able to kill the run it observes)."""
    if cli_value is not None and int(cli_value) > 0:
        return int(cli_value)
    raw = os.environ.get(RING_CAPACITY_ENV)
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return DEFAULT_RING_CAPACITY


# The `flushed_on` labels a dump may carry: the lifecycle and fault
# reasons, "drain" (an orderly serving hand-off, distinct from a
# SIGTERM dump) and "incident" (a dump cut into a black-box bundle,
# telemetry/archive.py, while the process runs on).
FLUSH_REASONS = (
    "sigterm", "sigint", "atexit", "violation", "watchdog",
    "session-end", "manual", "drain", "incident",
)


class FlightRecorder:
    """Ring buffer of span events + periodic registry snapshots.

    Subscribes to the tracer's observer hook (telemetry/spans.py): each
    span open/close/mark appends one bounded-size event record; every
    `snapshot_interval_s` of event activity the registry's JSON
    exposition is snapshotted too (opportunistic — no timer thread; a
    run that emits no events gets its final-state snapshot at flush).
    `capacity` bounds the event window (oldest dropped, drop count
    kept); `max_snapshots` bounds the snapshot window.
    """

    def __init__(self, tracer, registry=None, path: str = FLIGHT_FILE,
                 capacity: int = DEFAULT_RING_CAPACITY,
                 snapshot_interval_s: float = 5.0,
                 max_snapshots: int = 8):
        self.tracer = tracer
        self.registry = (
            registry if registry is not None
            else getattr(tracer, "registry", None)
        )
        self.path = path
        self.capacity = int(capacity)
        self.snapshot_interval_s = float(snapshot_interval_s)
        self._events: deque = deque(maxlen=self.capacity)
        self._snapshots: deque = deque(maxlen=max_snapshots)
        self._t0 = time.perf_counter()
        self._last_snapshot_t = -float("inf")
        self._n_events_total = 0
        self._n_flushes = 0
        # A death/violation reason sticks: the teardown re-flush must
        # refresh the dump's CONTENT without relabeling the run as a
        # clean "session-end" (a /healthz violation mid-run would
        # otherwise be erased from the label at exit).
        self._sticky_reason: Optional[str] = None
        self._installed = False
        self._prev_handlers: Dict[int, Any] = {}
        # RLock, not Lock: signal handlers run on the main thread
        # between bytecodes, so a SIGTERM can land while observe()
        # holds the lock ON THE SAME THREAD — the flush path's
        # re-acquire must succeed, not deadlock the dying process.
        self._lock = threading.RLock()

    # -- recording ----------------------------------------------------
    def observe(self, kind: str, sp) -> None:
        """Tracer observer callback (see spans.Tracer.add_observer)."""
        rec: Dict[str, Any] = {
            "kind": kind,
            "name": sp.name,
            "t": round(time.perf_counter() - self._t0, 4),
            "ts": sp.ts,
            "attrs": dict(sp.attrs),
        }
        if kind == "close":
            rec["wall_ms"] = sp.wall_ms
        with self._lock:
            self._events.append(rec)
            self._n_events_total += 1
            now = time.perf_counter()
            if (
                self.registry is not None
                and now - self._last_snapshot_t >= self.snapshot_interval_s
            ):
                self._last_snapshot_t = now
                self._snapshots.append({
                    "t": round(now - self._t0, 4),
                    "ts": _iso_now(),
                    "metrics": self.registry.to_dict(),
                })

    # -- dumping ------------------------------------------------------
    def to_dict(self, reason: str = "manual") -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
            snapshots = list(self._snapshots)
            n_total = self._n_events_total
        return {
            "schema_version": FLIGHT_SCHEMA_VERSION,
            "kind": "flight",
            "flushed_on": reason,
            "ts": _iso_now(),
            "n_flushes": self._n_flushes,
            "capacity": self.capacity,
            "n_events_total": n_total,
            "dropped_events": max(0, n_total - len(events)),
            "span_stack": self.tracer.stack_snapshot(),
            "events": events,
            "snapshots": snapshots,
            "metrics": (
                self.registry.to_dict()
                if self.registry is not None else None
            ),
        }

    def flush(self, reason: str = "manual") -> str:
        """Atomically (re)write the dump; returns the path.  Never
        raises — a broken flush in a signal handler or atexit callback
        must not mask the run's own failure."""
        from ..utils.io import atomic_write_json

        self._n_flushes += 1
        if reason in ("sigterm", "sigint", "violation", "watchdog",
                      "drain"):
            # "drain" sticks too: after an orderly serving hand-off the
            # atexit re-flush keeps saying drain, and a drain that began
            # as SIGTERM relabels the dump (the daemon's drain flushes
            # after the signal's).
            self._sticky_reason = reason
        elif self._sticky_reason is not None and reason in (
            "session-end", "atexit"
        ):
            reason = self._sticky_reason
        try:
            dump = self.to_dict(reason)
            atomic_write_json(self.path, dump)
        except Exception:  # noqa: BLE001 - last-resort telemetry path
            import logging

            logging.getLogger("image_analogies_tpu_torch").exception(
                "flight recorder: flush to %s failed", self.path
            )
        return self.path

    # -- lifecycle ----------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Subscribe to the tracer, register the atexit flush, and (in
        the main thread only — CPython restricts signal.signal) chain
        the SIGTERM/SIGINT handlers."""
        if self._installed:
            return self
        self._installed = True
        self.tracer.add_observer(self.observe)
        atexit.register(self._atexit_flush)
        if threading.current_thread() is threading.main_thread():
            for signum in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[signum] = signal.signal(
                        signum, self._on_signal
                    )
                except (ValueError, OSError):
                    # Embedded interpreters can refuse; the atexit +
                    # session-end flushes still apply.
                    pass
        return self

    def uninstall(self, final_reason: str = "session-end") -> None:
        """Final flush + restore handlers/atexit/observer — the
        telemetry session's normal teardown path."""
        if not self._installed:
            return
        self.flush(final_reason)
        self.tracer.remove_observer(self.observe)
        try:
            atexit.unregister(self._atexit_flush)
        except Exception:  # noqa: BLE001
            pass
        for signum, prev in self._prev_handlers.items():
            try:
                if signal.getsignal(signum) == self._on_signal:
                    signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _atexit_flush(self) -> None:
        self.flush("atexit")

    def _on_signal(self, signum, frame) -> None:
        reason = "sigterm" if signum == signal.SIGTERM else "sigint"
        self.flush(reason)
        prev = self._prev_handlers.get(signum)
        if signum == signal.SIGINT and callable(prev):
            # Defer to the previous SIGINT disposition (usually
            # default_int_handler -> KeyboardInterrupt), which unwinds
            # through the session's finally blocks.
            prev(signum, frame)
            return
        # SIGTERM (or SIGINT with a non-callable previous disposition):
        # the dump is on disk — now die the way the sender expects.
        # Raising (SystemExit) from here is NOT reliable: the handler
        # runs wherever the main thread happens to be, and an exception
        # raised into a GC-callback or __del__ frame is swallowed by
        # the interpreter ("Exception ignored in ..."), and the "killed"
        # run then flushes its dump and runs to completion.  Restoring the previous
        # disposition and re-delivering the signal terminates
        # deterministically, with the true killed-by-SIGTERM wait
        # status (the epilogue artifacts are then best-effort; the
        # flight dump IS the post-mortem, which is this module's
        # contract).
        try:
            signal.signal(
                signum, prev if prev is not None else signal.SIG_DFL
            )
        except (ValueError, OSError):
            pass
        signal.raise_signal(signum)


def stack_events(dump: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Convenience accessor for consumers/tests: the dump's event
    window, oldest first (already the on-disk order)."""
    return list(dump.get("events") or [])


def request_events(dump: Dict[str, Any],
                   request_id: str) -> List[Dict[str, Any]]:
    """Events belonging to one serving request (round 15): the
    `serve_request` roots carry `request_id` in their attrs, and the
    daemon replays each request's tree through the observer hook at
    settle, so a request that finished inside the ring's window shows
    up here — the `ia-synth trace` CLI's flight-side join."""
    return [
        ev for ev in stack_events(dump)
        if (ev.get("attrs") or {}).get("request_id") == request_id
    ]


def tree_events(dump: Dict[str, Any],
                request_id: str) -> List[Dict[str, Any]]:
    """Every event of every span TREE rooted at `request_id` — the
    round-22 fleet-trace accessor.  `request_events` only matches
    events whose own attrs carry the id; a request tree's lifecycle
    children (enqueue/dispatch/... on a replica, or a grafted run
    subtree) do not.  Attached trees are replayed depth-first through
    the observer hook (spans.Tracer.attach_tree), so in the ring a
    root's open..close bracket contains exactly its tree: track the
    open/close depth from each matching root's open event and collect
    until it returns to zero.  Events the ring already evicted are
    simply absent — honest truncation, never reconstruction."""
    out: List[Dict[str, Any]] = []
    depth = 0
    for ev in stack_events(dump):
        kind = ev.get("kind")
        if depth == 0:
            if (kind == "open"
                    and (ev.get("attrs") or {}).get("request_id")
                    == request_id):
                depth = 1
                out.append(ev)
            continue
        out.append(ev)
        if kind == "open":
            depth += 1
        elif kind == "close":
            depth -= 1
    return out


def read_flight(path: str) -> Dict[str, Any]:
    import json

    with open(path) as f:
        return json.load(f)


def install_for_session(tracer, registry, artifact_dir: str,
                        **kw) -> FlightRecorder:
    """The telemetry_session wiring: a recorder dumping into
    `<artifact_dir>/flight.json`, installed and returned.  Callers
    that do not pass `capacity` get the env-aware resolution
    (IA_FLIGHT_RING, else the default)."""
    os.makedirs(artifact_dir, exist_ok=True)
    kw.setdefault("capacity", resolve_ring_capacity())
    rec = FlightRecorder(
        tracer, registry, os.path.join(artifact_dir, FLIGHT_FILE), **kw
    )
    return rec.install()

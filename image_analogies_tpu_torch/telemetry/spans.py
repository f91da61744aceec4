"""Hierarchical span tracing: the host half of the telemetry layer.

A `Span` is one timed region of a run (the whole run, a pyramid level,
the prologue); a `Tracer` owns the open span stack, the finished span
forest and an optional event sink.  The reference's rules, kept:

1. **No cost when disabled.**  The runners call `tracer.span(...)` in
   their level loops; a disabled tracer returns one shared no-op context
   and never reads the clock or syncs the device.  `as_tracer(progress)`
   at every runner entry maps None to the disabled singleton, a
   ProgressWriter to an enabled tracer, and a Tracer to itself.

2. **The JSONL stream is a view of the span tree.**  A span named in
   `_SPAN_EVENTS` emits its event (`level_done`, `prologue`, `run_done`)
   on close, with its attrs and `wall_ms`; ad-hoc events (`start`,
   `done`, `resume`) go through `Tracer.emit`, which also records them
   as zero-length marks on the tree.

3. **EM steps and matcher phases are declared, not timed.**  Their
   device work is queued asynchronously inside the level, so the host
   cannot clock them without a sync each; they are recorded as untimed
   child spans (`wall_ms` null), and their device time is read from a
   `torch.profiler` trace by the `record_function` ranges of the same
   names (`utils/profiling.scope`).

Schema (the reference's, version 1):

    span: {"name": str, "t": rel-start-s, "ts": ISO-8601 UTC start,
           "wall_ms": float | None (untimed), "attrs": {...},
           "children": [span, ...]}
    tree: {"schema_version": 1, "t0": ISO-8601, "spans": [span, ...]}

Left out until the serving slice: the reference's after-the-fact request
trees (`attach_tree`, `span_at`, `new_span_id`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..utils.progress import _iso_now

SCHEMA_VERSION = 1

# Span name -> event emitted on close (rule 2).  Other spans are
# tree-only.
_SPAN_EVENTS = {
    "level": "level_done",
    "prologue": "prologue",
    "run": "run_done",
}


class Span:
    """One node of the span tree, made by `Tracer.span` (timed) or
    `Tracer.annotate` (untimed); closes on context exit.  `set(**attrs)`
    attaches fields while it is open."""

    __slots__ = (
        "name", "attrs", "children", "t_start", "t_end", "ts", "timed",
        "_tracer",
    )

    def __init__(self, name: str, attrs: Dict[str, Any], tracer,
                 timed: bool = True):
        self.name = name
        self.attrs = dict(attrs)
        self.children: List[Span] = []
        self.timed = timed
        self.t_start = time.perf_counter() if timed else None
        self.t_end: Optional[float] = None
        self.ts = _iso_now()
        self._tracer = tracer

    @property
    def wall_ms(self) -> Optional[float]:
        if not self.timed or self.t_end is None:
            return None
        return round((self.t_end - self.t_start) * 1000, 3)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.timed:
            self.t_end = time.perf_counter()
        self._tracer._close(self)

    def to_dict(self, t0: float) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "name": self.name,
            "ts": self.ts,
            "t": (
                round(self.t_start - t0, 4) if self.t_start is not None
                else None
            ),
            "wall_ms": self.wall_ms,
            "attrs": self.attrs,
        }
        if self.children:
            rec["children"] = [c.to_dict(t0) for c in self.children]
        return rec


class _NullSpan:
    """The one do-nothing span a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return self

    children = ()
    attrs: Dict[str, Any] = {}
    wall_ms = None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span collector and event emitter.

    `sink`: optional `utils.progress.ProgressWriter` (anything with
    `.emit(event, **fields)`) that receives the JSONL view.  `registry`:
    optional `telemetry.metrics.MetricsRegistry` the runners update
    beside the spans.  (The reference's `lean` tracer, which skips the
    per-level readback for the serving daemon's request traces, waits
    for the serving slice.)
    """

    def __init__(self, sink=None, registry=None, enabled: bool = True):
        self.enabled = enabled
        self.sink = sink
        self.registry = registry
        self._t0 = time.perf_counter()
        self._ts0 = _iso_now()
        self._stack: List[Span] = []
        self.roots: List[Span] = []
        # Span-event observers (the flight recorder, the supervisor's
        # watchdog): fn(kind, span), kind in {"open", "close", "mark"}.
        # Every notify site checks the list first, so tracing without
        # observers pays one falsy branch.
        self._observers: List = []

    def add_observer(self, fn) -> None:
        """Subscribe fn(kind, span) to span open/close/mark events."""
        self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        if fn in self._observers:
            self._observers.remove(fn)

    def _notify(self, kind: str, sp: "Span") -> None:
        for fn in self._observers:
            fn(kind, sp)

    # -- recording ----------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a timed span as a context manager; emits the span's event
        (if any) on close."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(name, attrs, self)
        self._push(sp)
        if self._observers:
            self._notify("open", sp)
        return sp

    def annotate(self, name: str, parent: Optional[Span] = None, **attrs):
        """Record an untimed child span under `parent` (default: the open
        span): structure whose host wall means nothing (rule 3)."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(name, attrs, self, timed=False)
        if parent is not None:
            parent.children.append(sp)
        else:
            self._attach(sp)
        if self._observers:
            self._notify("mark", sp)
        return sp

    def record(self, name: str, wall_ms: float, **attrs):
        """Record an already-measured span (the prologue, a batch level),
        closed at once with the given wall and emitting its event like a
        context-managed span; `t_start` and `ts` are backdated by
        `wall_ms`."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(name, attrs, self)
        sp.t_start = time.perf_counter() - wall_ms / 1000.0
        sp.t_end = sp.t_start + wall_ms / 1000.0
        sp.ts = _iso_now(-wall_ms)
        self._attach(sp)
        self._close(sp)
        return sp

    def emit(self, event: str, **fields) -> None:
        """Ad-hoc event (`start`, `done`, `resume`): forwarded to the sink
        and recorded as a zero-length mark, so a ProgressWriter call site
        can pass a Tracer unchanged."""
        if not self.enabled:
            return
        mark = Span(event, fields, self, timed=False)
        self._attach(mark)
        if self._observers:
            self._notify("mark", mark)
        if self.sink is not None:
            self.sink.emit(event, **fields)

    # -- internals ----------------------------------------------------
    def _attach(self, sp: Span) -> None:
        (self._stack[-1].children if self._stack else self.roots).append(sp)

    def _push(self, sp: Span) -> None:
        self._attach(sp)
        self._stack.append(sp)

    def _close(self, sp: Span) -> None:
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        if self._observers:
            self._notify("close", sp)
        event = _SPAN_EVENTS.get(sp.name)
        if event and self.sink is not None:
            fields = dict(sp.attrs)
            if sp.wall_ms is not None:
                fields["wall_ms"] = sp.wall_ms
            self.sink.emit(event, **fields)

    # -- output -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "t0": self._ts0,
            "spans": [s.to_dict(self._t0) for s in self.roots],
        }

    def write(self, path: str) -> None:
        """Write the span tree atomically (a temporary file and a
        rename): the session writes it in a crash's `finally`, and a
        half-written host_spans.json would poison the post-mortem."""
        from ..utils.io import atomic_write_json

        atomic_write_json(path, self.to_dict())

    def stack_snapshot(self) -> List[Dict[str, Any]]:
        """The open span stack, outermost first, as plain dicts: where
        the run is now (the flight recorder's `span_stack`).  Walks a
        tuple copy, so a push or pop on the run's thread cannot break
        it."""
        now = time.perf_counter()
        out = []
        for sp in tuple(self._stack):
            out.append({
                "name": sp.name,
                "attrs": dict(sp.attrs),
                "ts": sp.ts,
                "open_s": (
                    round(now - sp.t_start, 3)
                    if sp.t_start is not None else None
                ),
            })
        return out

    def find(self, name: str) -> List[Span]:
        """All spans named `name`, depth first."""
        out: List[Span] = []

        def walk(spans):
            for s in spans:
                if s.name == name:
                    out.append(s)
                walk(s.children)

        walk(self.roots)
        return out


NULL_TRACER = Tracer(enabled=False)


def as_tracer(progress) -> Tracer:
    """A runner's `progress` argument as a tracer: None -> the disabled
    singleton; a Tracer -> itself; anything with `.emit` (a
    ProgressWriter) -> an enabled Tracer emitting through it."""
    if progress is None:
        return NULL_TRACER
    if isinstance(progress, Tracer):
        return progress
    return Tracer(sink=progress)

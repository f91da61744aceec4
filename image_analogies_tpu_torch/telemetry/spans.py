"""Hierarchical span tracing: the host half of the telemetry layer.

A `Span` is one timed region of a run (the whole run, a pyramid level,
an EM step, a matcher phase, the prologue); a `Tracer` owns the open
span stack, the finished span forest and an optional event sink.  The
reference's first two rules, kept, and two of the port's:

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

3. **One primitive at every layer boundary below the runner.**
   `scope(range, span, **attrs)` opens the `torch.profiler` range
   `range` (the reference's `jax.named_scope` tag: `tlm_em{em}`,
   `tlm_match`, `tlm_sweep`, ...) while a profiler records, and the
   child span `span` on the tracer current in this thread or context;
   with neither it returns the shared no-op after one check.  A tracer
   is current while one of its own `span`s is open (the runner's `run`,
   or the `level` of a runner with no `run` span), a context variable,
   so the serving daemon's worker threads never share one.  A `lean`
   tracer's open span makes none current: below its levels nothing is
   recorded, and its level spans carry the declared `em_iter` marks
   instead.  So EM steps and matcher phases are live spans of an
   enabled, non-lean tracer: `wall_ms` / `host_ms` is the host's issue
   time (nothing inside a level syncs the device), and their device time
   comes from the CUDA events below.

4. **Device intervals without a sync.**  An enabled, non-`lean` tracer
   bound to a CUDA device (`Tracer.bind_device`) records a timing event on the current stream
   at every span's open and close, and once, at its first span, an
   anchor: one device sync, an event and `time.perf_counter()`.  A
   span's device start and end are then the anchor's host time plus the
   events' distance from the anchor: on the host's clock, beside the
   host times.  Events are resolved lazily (`Tracer.resolve`): reading a
   span's device fields waits once, on the newest end event; `to_dict`
   and `write` take the intervals the device has reached without
   waiting.  Nothing in the run waits on them.  A lean tracer
   (the serving daemon's per-request one) and a CPU run record none;
   their device fields are None.

Schema (the reference's, version 1, with the port's timing fields):

    span: {"name": str, "t": rel-start-s, "ts": ISO-8601 UTC start,
           "wall_ms": float | None (untimed), "attrs": {...},
           "host_ms": float (timed spans),
           "device_ms", "device_t", "device_end_t": float (spans with
               a device interval; the two `t`s relative like "t"),
           "children": [span, ...]}
    tree: {"schema_version": 1, "t0": ISO-8601, "spans": [span, ...]}

The serving daemon builds its request trees after the fact
(`span_at`, `Tracer.attach_tree`, `new_span_id`), as the reference's.
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

from ..utils.progress import _iso_now

SCHEMA_VERSION = 1

# Span name -> event emitted on close (rule 2).  Other spans are
# tree-only.
_SPAN_EVENTS = {
    "level": "level_done",
    "prologue": "prologue",
    "run": "run_done",
}

# The enabled, non-lean tracer whose span is open in this thread or
# context (rule 3); `scope` opens its spans there.
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "image_analogies_tpu_torch.tracer", default=None)


def _record_event(device):
    """A CUDA timing event recorded now on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _device_sync(device) -> None:
    torch.cuda.synchronize(device)


class Span:
    """One node of the span tree, made by `Tracer.span` (timed) or
    `Tracer.annotate` (untimed); closes on context exit.  `set(**attrs)`
    attaches fields while it is open.  `dev_t0` / `dev_t1`: its device
    interval on the `time.perf_counter()` clock (rule 4), None until
    resolved or where no events were recorded."""

    __slots__ = (
        "name", "attrs", "children", "t_start", "t_end", "ts", "timed",
        "_tracer", "_ev0", "_ev1", "dev_t0", "dev_t1", "_token",
    )

    def __init__(self, name: str, attrs: Dict[str, Any], tracer,
                 timed: bool = True, ev0=None):
        self.name = name
        self.attrs = dict(attrs)
        self.children: List[Span] = []
        self.timed = timed
        self.t_start = time.perf_counter() if timed else None
        self.t_end: Optional[float] = None
        self.ts = _iso_now()
        self._tracer = tracer
        self._ev0 = ev0
        self._ev1 = None
        self.dev_t0: Optional[float] = None
        self.dev_t1: Optional[float] = None
        self._token = None

    @property
    def wall_ms(self) -> Optional[float]:
        if not self.timed or self.t_end is None:
            return None
        return round((self.t_end - self.t_start) * 1000, 3)

    @property
    def host_ms(self) -> Optional[float]:
        """Open to close on the host's clock, unrounded: below the level
        (no sync inside) the time the host took to issue the span's
        work."""
        if not self.timed or self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1000.0

    @property
    def device_ms(self) -> Optional[float]:
        """Start event to end event on the device (rule 4); None without
        events."""
        if self._ev1 is not None:
            self._tracer.resolve()
        if self.dev_t0 is None:
            return None
        return (self.dev_t1 - self.dev_t0) * 1000.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        # Rule 3: inside its span the tracer is the current one (a lean
        # tracer makes none current).
        target = None if self._tracer.lean else self._tracer
        if self.timed and _CURRENT.get() is not target:
            self._token = _CURRENT.set(target)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.timed:
            self.t_end = time.perf_counter()
            if self._ev0 is not None:
                self._tracer._add_pending(
                    self, _record_event(self._tracer.device))
        self._tracer._close(self)
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None

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
        if self.t_end is not None and self.timed:
            rec["host_ms"] = round(self.host_ms, 4)
        if self.dev_t0 is not None:
            rec["device_ms"] = round(self.device_ms, 4)
            rec["device_t"] = round(self.dev_t0 - t0, 6)
            rec["device_end_t"] = round(self.dev_t1 - t0, 6)
        if self.children:
            rec["children"] = [c.to_dict(t0) for c in self.children]
        return rec


class _NullSpan:
    """The one do-nothing context every disabled path hands out: a
    disabled tracer's spans, and `scope` with no tracer and no
    profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return self

    children = ()
    attrs: Dict[str, Any] = {}
    wall_ms = host_ms = device_ms = None


_NULL_SPAN = _NullSpan()


class _Boundary:
    """`scope` under a recording profiler: the `record_function` range,
    and inside it the current tracer's span when there is one."""

    __slots__ = ("_range", "_tracer", "_name", "_attrs", "_rf", "_sp")

    def __init__(self, range_name: str, tracer, name, attrs):
        self._range = range_name
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._rf = self._sp = None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._range)
        self._rf.__enter__()
        self._sp = (self._tracer.span(self._name, **self._attrs)
                    if self._tracer is not None else _NULL_SPAN)
        return self._sp.__enter__()

    def __exit__(self, *exc):
        self._sp.__exit__(*exc)
        return self._rf.__exit__(*exc)


def scope(range_name: str, span: Optional[str] = None, **attrs):
    """The span primitive at a layer boundary (rule 3): the profiler
    range `range_name` while a profiler records, and the span `span`
    (with `attrs`) on the current tracer when there is one; else the
    shared no-op, after one check, with no clock read and no event."""
    tracer = _CURRENT.get() if span is not None else None
    if torch.autograd.profiler._is_profiler_enabled:
        return _Boundary(range_name, tracer, span, attrs)
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(span, **attrs)


class Tracer:
    """Span collector and event emitter.

    `sink`: optional `utils.progress.ProgressWriter` (anything with
    `.emit(event, **fields)`) that receives the JSONL view.  `registry`:
    optional `telemetry.metrics.MetricsRegistry` the runners update
    beside the spans.  `lean` asks the runners to skip optional device
    readbacks (the batch runner's per-level energy mean) while keeping
    the span tree, and records no device events: the serving daemon's
    per-request run tracer sets it, so request tracing adds no device
    sync to the hot path.  `device`: the CUDA device whose current
    stream its spans time (rule 4), bound by `bind_device`; None records
    no events.
    """

    def __init__(self, sink=None, registry=None, enabled: bool = True,
                 lean: bool = False):
        self.enabled = enabled
        self.lean = lean
        self.sink = sink
        self.registry = registry
        self.device = None
        self._t0 = time.perf_counter()
        self._ts0 = _iso_now()
        self._stack: List[Span] = []
        self.roots: List[Span] = []
        # (event, perf_counter) taken after one sync at the first timed
        # span; closed spans whose events are not resolved yet.
        self._anchor = None
        self._pending: List[Span] = []
        self._pending_lock = threading.Lock()
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

    def bind_device(self, device) -> None:
        """Time this tracer's spans on `device`'s current stream (rule 4):
        every runner binds its device before its first span.  Only an
        enabled, non-lean tracer takes a device, and only its first CUDA
        one; on anything else this does nothing."""
        if (self.enabled and not self.lean and self.device is None
                and device is not None
                and torch.device(device).type == "cuda"):
            self.device = torch.device(device)

    # -- recording ----------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a timed span as a context manager; emits the span's event
        (if any) on close."""
        if not self.enabled:
            return _NULL_SPAN
        ev0 = self._event() if self.device is not None else None
        sp = Span(name, attrs, self, ev0=ev0)
        self._push(sp)
        if self._observers:
            self._notify("open", sp)
        return sp

    def annotate(self, name: str, parent: Optional[Span] = None, **attrs):
        """Record an untimed child span under `parent` (default: the open
        span): a mark whose host wall means nothing (`run_plan`, the
        supervisor's recoveries)."""
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
        """Record an already-measured span (the prologue), closed at once
        with the given wall and emitting its event like a
        context-managed span; `t_start` and `ts` are backdated by
        `wall_ms`.  It carries no device interval."""
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

    # -- grafting -----------------------------------------------------
    def attach_tree(self, root: Span) -> None:
        """Adopt an already-closed span tree as a new root WITHOUT
        touching the active stack — the serving daemon's per-request
        trees are built after the fact (requests overlap arbitrarily,
        so they can't live on the strictly-nested stack) and grafted
        here so `to_dict`/`find`/the flight recorder see one forest.
        Observers are replayed depth-first (open before children,
        close after), so the flight recorder's event window records
        the adopted tree like any live one; legacy sink events are NOT
        re-fired (the tree's original tracer already emitted them)."""
        if not self.enabled:
            return
        self.roots.append(root)
        if not self._observers:
            return

        def replay(sp: Span) -> None:
            self._notify("open", sp)
            for c in sp.children:
                replay(c)
            self._notify("close", sp)

        replay(root)

    # -- device intervals (rule 4) ------------------------------------
    def _event(self):
        """A timing event now; the first one takes the anchor."""
        if self._anchor is None:
            _device_sync(self.device)
            anchor = _record_event(self.device)
            self._anchor = (anchor, time.perf_counter())
        return _record_event(self.device)

    def _add_pending(self, sp: Span, ev1) -> None:
        """Close `sp`'s device interval with end event `ev1`: a span
        whose `_ev1` another thread sees is pending or resolved."""
        with self._pending_lock:
            sp._ev1 = ev1
            self._pending.append(sp)

    def resolve(self, wait: bool = True) -> None:
        """Give every closed span with events its device interval: the
        anchor's host time plus each event's distance from the anchor.
        `wait` waits once, on the newest end event (spans close in
        order on one stream, so every older event has then been
        reached); without it, only spans whose end the device has
        reached are resolved and the rest stay pending."""
        # Under the lock throughout: a reader on another thread waits
        # here until its span is resolved, never finds it half done.
        with self._pending_lock:
            if not self._pending:
                return
            if wait:
                self._pending[-1]._ev1.synchronize()
            anchor, t_anchor = self._anchor
            late = []
            for sp in self._pending:
                if not wait and not sp._ev1.query():
                    late.append(sp)
                    continue
                sp.dev_t0 = t_anchor + anchor.elapsed_time(sp._ev0) / 1e3
                sp.dev_t1 = t_anchor + anchor.elapsed_time(sp._ev1) / 1e3
                sp._ev0 = sp._ev1 = None
            self._pending = late

    # -- output -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """The tree in the module's schema, with the device intervals the
        device has reached resolved first, without waiting: the live
        exporter reads it mid-run, and a crashed run's session writes it
        whatever state the device is in."""
        self.resolve(wait=False)
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


def span_at(name: str, t_start: float, t_end: float,
            **attrs) -> Span:
    """Build a DETACHED timed Span from explicit perf_counter readings
    (`time.perf_counter()` values, the same process-wide clock every
    live span samples) — the primitive the serving daemon uses to
    reconstruct a request's lifecycle as real spans after the fact.
    The span is closed (t_end set) but belongs to no tracer; compose
    with `Span.children` + `Tracer.attach_tree`.  `ts` is backdated so
    the schema's 'ts = start' promise holds."""
    sp = Span(name, attrs, NULL_TRACER)
    sp.t_start = float(t_start)
    sp.t_end = max(float(t_start), float(t_end))
    sp.ts = _iso_now(-(time.perf_counter() - sp.t_start) * 1000.0)
    return sp


def new_span_id() -> str:
    """Fresh 12-hex id — the shared grammar for generated request ids
    AND span ids (`^[A-Za-z0-9._-]{1,64}$` accepts it), so the round-15
    replaced-never-rejected policy has one generator for both the
    `X-Request-Id` and `X-Parent-Span` headers (serving/daemon.py,
    serving/router.py)."""
    return uuid.uuid4().hex[:12]


def as_tracer(progress) -> Tracer:
    """A runner's `progress` argument as a tracer: None -> the disabled
    singleton; a Tracer -> itself; anything with `.emit` (a
    ProgressWriter) -> an enabled Tracer emitting through it."""
    if progress is None:
        return NULL_TRACER
    if isinstance(progress, Tracer):
        return progress
    return Tracer(sink=progress)

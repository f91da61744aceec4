"""Request queue, continuous batching, and admission control for the
serving daemon (with serving/excache.py and serving/daemon.py): the
reference's module, copied; the shape lattice's crop waits for ROADMAP
Queue 1 step 13b.

Three pure-testable policy pieces, kept free of HTTP and engine
imports so tests/test_serving.py can unit-test them with stub
requests:

  - `coalesce(entries, now, policy)` — the continuous-batching
    decision: queued requests whose COMPAT KEY matches the head's
    (executable key + luminance-stats bucket, serving/daemon.py)
    coalesce into one `parallel/batch` dispatch.  The batch flushes
    when it reaches `max_batch` or when the HEAD request has waited
    `max_wait_ms` — head-of-line age, not batch age, so a lone
    request's latency is bounded by max_wait regardless of arrival
    pattern.  Incompatible requests behind the head stay queued for a
    later batch (no reordering within a compat key: FIFO per key).
  - `AdmissionController` — the backpressure decision: a request is
    shed (HTTP 429 + Retry-After) when queue depth reaches
    `max_depth`; the threshold HALVES while the backend is degraded
    (the existing straggler gauge `ia_shard_imbalance_ratio` over the
    sentinel's IMBALANCE_RATIO_MAX, or the supervisor's degradation
    counter moving), so a struggling backend sheds load before it
    wedges rather than after.  Retry-After is estimated from observed
    service latency x backlog, clamped to [1, 60] s.
  - `demux(batch, stacked)` — the per-request result fan-out: row i of
    the dispatched stack belongs to batch[i] by construction (the
    daemon stacks frames in batch order), so demux is positional and
    its ordering is pinned by unit test, not convention.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ServeRequest:
    """One in-flight synthesis request (daemon-internal).

    `compat` is the batching identity: the executable key PLUS the
    luminance-stats bucket PLUS the session id (None for sessionless
    traffic) — two requests coalesce only if they share a compiled
    executable AND the same canonical remap statistics AND the same
    session, so a sessionless request's output never depends on its
    co-tenants (the batch-composition-independence contract,
    serving/daemon.py) and a session's frames never share a dispatch
    with strangers."""

    frame: Any  # np.ndarray (H, W, C) float32
    key: tuple  # executable key (serving/excache.exec_key)
    compat: tuple  # key + (luminance bucket, session id)
    b_stats: Optional[Tuple[float, float]]  # canonical bucket stats
    session: Optional[str] = None  # session-affinity id (daemon)
    req_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    # Inbound distributed-trace context (round 22): the upstream span
    # id (the router's `X-Parent-Span`) and hop count, validated at
    # ingest; None for untraced/direct traffic.  Recorded on the
    # serve_request root's attrs so the router and replica trees join.
    trace_parent: Optional[str] = None
    trace_hop: Optional[int] = None
    enqueue_t: float = field(default_factory=time.monotonic)
    # Absolute anchors for the SAME instant `enqueue_t` names: `t0` is
    # wall-clock epoch seconds (so post-mortem dumps from DIFFERENT
    # requests — whose monotonic zeroes are all their own enqueue — can
    # be ordered against each other), `enqueue_perf` is the
    # perf_counter reading the Tracer's span clock uses (so the
    # request's lifecycle events can be replayed as real spans on the
    # daemon tracer's timeline).  The relative `t_ms` span fields stay.
    t0: float = field(default_factory=time.time)
    enqueue_perf: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)
    # Round-16 resilience fields.  `deadline_t` is the client deadline
    # as a monotonic instant (None: no deadline); the dispatcher drops
    # a queued request whose deadline already passed instead of paying
    # a dispatch it cannot use.  `alive` is a zero-arg socket-liveness
    # probe bound to the client connection (None: unknown — treat as
    # alive); the dispatcher cancels queued requests whose probe says
    # the client hung up.  `replay` marks a request reconstructed from
    # the journal during takeover (no waiting client; the journal mark
    # is the response).  `manifest` keeps the parsed request body for
    # journaling at admission.
    deadline_t: Optional[float] = None
    alive: Any = None  # Optional[Callable[[], bool]]
    replay: bool = False
    manifest: Optional[Dict[str, Any]] = field(default=None, repr=False)
    # Filled by the dispatcher before `done` is set:
    result: Any = None  # np.ndarray output frame on success
    error: Optional[str] = None  # failure detail (maps to 5xx)
    status: str = "queued"  # queued|ok|failed|cancelled
    cache: Optional[str] = None  # hit|miss for this request's dispatch
    batch_size: int = 0  # real (unpadded) co-tenant count
    # Prologue wall of this request's dispatch (ms) — the compile-phase
    # attribution the access log splits out of the execution window;
    # None when the dispatch carried no run tracer (sessions, disabled
    # observability).
    compile_ms: Optional[float] = None
    spans: List[Dict[str, Any]] = field(default_factory=list)

    def span(self, name: str) -> None:
        """Append a lifecycle span event (queued -> admitted ->
        compiled|cache-hit -> executed -> demuxed), timestamped
        relative to enqueue — plain dicts, not Tracer spans, because
        requests overlap arbitrarily across threads while the Tracer's
        span stack is strictly nested.  (The daemon converts them into
        a real per-request span tree at settle time, on the dispatcher
        thread, where no stack discipline is violated.)  `t_abs` is the
        wall-clock instant (`t0` + the relative offset)."""
        t_ms = round((time.monotonic() - self.enqueue_t) * 1000.0, 3)
        self.spans.append({
            "name": name,
            "t_ms": t_ms,
            "t_abs": round(self.t0 + t_ms / 1000.0, 6),
        })


@dataclass(frozen=True)
class BatchingPolicy:
    """max_batch: dispatch grain (and padding target — every dispatch
    is padded to exactly this many frames so the executable cache sees
    ONE batch shape per request shape).  max_wait_ms: the longest the
    queue head may age before a partial batch flushes."""

    max_batch: int = 4
    max_wait_ms: float = 25.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 ({self.max_batch})")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0 ({self.max_wait_ms})"
            )


def coalesce(entries: Sequence[ServeRequest], now: float,
             policy: BatchingPolicy) -> Optional[List[ServeRequest]]:
    """The batching decision over a snapshot of the queue (oldest
    first): return the head-compatible batch to dispatch now, or None
    (keep waiting — more compatible requests may arrive before the
    head ages out).  Pure: no locking, no popping; the caller removes
    the returned requests under its own lock."""
    if not entries:
        return None
    head = entries[0]
    batch = [r for r in entries if r.compat == head.compat]
    batch = batch[: policy.max_batch]
    if len(batch) >= policy.max_batch:
        return batch
    if (now - head.enqueue_t) * 1000.0 >= policy.max_wait_ms:
        return batch
    return None


def head_deadline(entries: Sequence[ServeRequest],
                  policy: BatchingPolicy) -> Optional[float]:
    """monotonic time at which the head's max-wait expires (the
    dispatcher's sleep bound), or None for an empty queue."""
    if not entries:
        return None
    return entries[0].enqueue_t + policy.max_wait_ms / 1000.0


class RequestQueue:
    """Thread-safe FIFO between HTTP handler threads (producers) and
    the dispatcher thread (consumer), with a condition variable so the
    dispatcher sleeps exactly until new work or the head's max-wait
    deadline."""

    def __init__(self):
        self._q: "deque[ServeRequest]" = deque()
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, req: ServeRequest) -> None:
        with self._cond:
            self._q.append(req)
            self._cond.notify_all()

    def next_batch(self, policy: BatchingPolicy,
                   timeout: float = 0.5) -> Optional[List[ServeRequest]]:
        """Block (up to `timeout`) for the next dispatchable batch,
        removing it from the queue.  Returns None on timeout with no
        flushable batch — the dispatcher loops so shutdown checks run
        at least every `timeout` seconds."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                batch = coalesce(list(self._q), now, policy)
                if batch is not None:
                    ids = {id(r) for r in batch}
                    kept = [r for r in self._q if id(r) not in ids]
                    self._q.clear()
                    self._q.extend(kept)
                    return batch
                if now >= deadline:
                    return None
                head_dl = head_deadline(list(self._q), policy)
                wait_until = deadline if head_dl is None else min(
                    deadline, head_dl
                )
                self._cond.wait(max(0.001, wait_until - now))

    def drain(self) -> List[ServeRequest]:
        """Remove and return everything queued (shutdown path: the
        daemon fails the leftovers as 'shutting down' rather than
        leaving their handler threads blocked forever)."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
            return out


class AdmissionController:
    """Shed-or-admit, consulted by handler threads BEFORE enqueueing.

    The effective depth limit is `max_depth`, halved while
    `backend_degraded()` — wired to the same gauges the sentinel
    grades (`ia_shard_imbalance_ratio` against IMBALANCE_RATIO_MAX,
    plus any supervisor degradation bookings), so backpressure
    tightens the moment the backend starts limping, not when the
    queue finally overflows."""

    def __init__(self, max_depth: int = 32, registry=None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1 ({max_depth})")
        self.max_depth = int(max_depth)
        self._registry = registry

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ..telemetry.metrics import get_registry

        return get_registry()

    def backend_degraded(self) -> bool:
        from ..telemetry.sentinel import IMBALANCE_RATIO_MAX

        snap = self._reg().to_dict()
        for v in snap.get("ia_shard_imbalance_ratio", {}).get(
            "values", {}
        ).values():
            if isinstance(v, (int, float)) and v > IMBALANCE_RATIO_MAX:
                return True
        degr = snap.get("ia_degradations_total", {}).get("values", {})
        return any(v for v in degr.values())

    def effective_depth(self) -> int:
        if self.backend_degraded():
            return max(1, self.max_depth // 2)
        return self.max_depth

    def admit(self, queue_depth: int,
              inflight: int) -> Tuple[bool, Optional[float]]:
        """(True, None) to admit, (False, retry_after_s) to shed.
        In-flight work counts against the limit too: a full batch
        mid-execution is backlog the client will wait behind."""
        limit = self.effective_depth()
        if queue_depth + inflight < limit:
            return True, None
        return False, self.retry_after(queue_depth + inflight)

    def retry_after(self, backlog: int) -> float:
        """Seconds the shed client should wait: observed p50 service
        latency x backlog ahead of it (the closed-loop drain time),
        clamped to [1, 60] — an estimate, deliberately coarse."""
        est = self.service_p50_s() * max(1, backlog)
        return round(min(60.0, max(1.0, est)), 1)

    def service_p50_s(self) -> float:
        """Observed p50 service-phase latency in seconds (0.0 before
        any request completed — cold daemons price deadlines at
        queue-wait only)."""
        p50 = self._reg().histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        ).quantile(0.5, labels={"phase": "service"})
        p50_ms = float(p50) if isinstance(p50, (int, float)) else 0.0
        return p50_ms / 1000.0

    def deadline_permits(self, deadline_t: Optional[float],
                         queue_depth: int, inflight: int,
                         now: Optional[float] = None) -> bool:
        """The hedged-shedding decision (round 16): would this request
        plausibly finish before its client deadline?  Prices the work
        AHEAD of it — (backlog + itself) x p50 service — against the
        time remaining; a request that cannot make it is shed at
        admission instead of wasting a dispatch the client will never
        read.  No deadline, or no latency history yet, admits."""
        if deadline_t is None:
            return True
        if now is None:
            now = time.monotonic()
        remaining = deadline_t - now
        if remaining <= 0.0:
            return False
        p50 = self.service_p50_s()
        if p50 <= 0.0:
            return True
        est = p50 * (queue_depth + inflight + 1)
        return est <= remaining


def demux(batch: Sequence[ServeRequest], stacked) -> None:
    """Fan the dispatched stack's rows back out to their requests:
    row i -> batch[i], by construction of the dispatch (the daemon
    stacks `[r.frame for r in batch]` in batch order and the runner
    preserves frame order through padding/trim).  Marks each request
    ok; the caller sets `done` after response fields are final."""
    if len(stacked) < len(batch):
        raise ValueError(
            f"demux: {len(stacked)} output rows for {len(batch)} "
            "requests"
        )
    for i, req in enumerate(batch):
        req.result = stacked[i]
        req.status = "ok"
        req.span("demuxed")

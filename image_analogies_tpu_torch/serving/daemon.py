"""The synthesis daemon: synthesis-as-a-service over the port's runners
(serving/excache.py holds the executable-cache accounting,
serving/queueing.py the batching and admission policy, and `serve` in
cli.py the front door).  The reference's daemon, ported to one card.

One long-lived process, one style pair: the daemon loads (A, A') at
startup (the batch runner's shared-style contract) and serves
`POST /synthesize` requests carrying a B image each, on the same HTTP
server the per-run exporter uses (`telemetry/live.py`, with injected
routes and a health callback), so `/metrics`, `/metrics.json`,
`/healthz`, `/progress` and the `live.json` rendezvous work alike for a
daemon and a run.  It runs on `cfg.device`: a "cuda" daemon on a
machine without a card raises at construction and never carries on on
the CPU.

Request lifecycle (the span names, in order):

    queued      handler thread validated + enqueued the request
    admitted    dispatcher popped it into a batch
    cache-hit | compiled
                the executable cache's verdict for the dispatch
    executed    the batch dispatch returned, its output on the host
    demuxed     this request's output row was fanned back out

Isolation contract: a request's output never depends on its
co-tenants.  Two constructions enforce it:

  - Random draws: every dispatch passes `frame_indices=[0]*grain` to
    `synthesize_batch`, so each frame draws the streams of a solo
    one-frame run regardless of batch position.
  - Luminance statistics: the batch runner normalizes style luminance
    over the whole stack, which would leak co-tenant statistics into
    every output.  The daemon instead computes each request's (mu,
    sigma) at admission, quantizes both to 1/32 buckets, makes the
    bucket part of the batching-compatibility key, and passes the
    BUCKET CENTER as the dispatch's canonical stats, so a request's
    remap depends only on its own bucket.  (The quantization perturbs
    the remap by at most half a bucket, the price of batchability.)

Static batch grain: every dispatch is padded (last frame repeated) to
exactly `max_batch` frames, so one request shape is one dispatch shape
and the executable cache's "repeat shape = hit" claim holds.  The
ballast rows are trimmed before demux.  The default grain is 1: there
is one device (the reference's default is its mesh's device count).

Failure containment: each dispatch runs under
`runtime/supervisor.supervise` with `tracer=None` (exception-retry
only) and `ladder=[]` (no degradation ladder: every rung flips
process-wide kernel modes, which would silently change co-tenant and
later outputs).  A give-up maps to HTTP 500 for that batch's requests;
the daemon keeps serving.

Device work stays on the dispatcher's thread (or the supervisor's
attempt thread it waits on): the dispatcher copies the output to the
host before it stamps `executed`, and the completer and the handler
threads touch only numpy arrays and bytes.

Session affinity: a request may carry a `session_id`, declaring itself
the next frame of a video.  The id joins the batching-compatibility
key (a session's frames never coalesce with strangers) and the
dispatcher routes session batches through a per-session
`video.VideoStream` held in an LRU table (`max_sessions`), so
consecutive frames warm-start from the session's carried state.  Inside
a session the output depends on session history, the remap statistics
freeze on the opening frame's luma bucket, and a failed dispatch fails
its requests and resets the session to cold.

Crash resilience (serving/journal.py): with a `state_dir` the daemon
appends every ADMITTED request to a durable journal before
acknowledging it, marks the entry retired when the response is written
(`done`), when the client vanished (`cancelled`), or when a successor
re-executed it (`replayed`), and on `--takeover` replays every
un-retired entry through the normal queue; the isolation contract makes
the replayed output bit-identical to the answer the dead daemon would
have given.  A graceful drain (SIGTERM or `POST /drain`) 503s new work,
lets in-flight batches and their response writes finish under a
deadline, then snapshots the observed shapes (`warmup.observed.json`)
and every resident session's carried state for the successor.  A
`daemon.lock` naming the holder pid makes a double takeover a refused
startup.

Pipelined dispatch: the dispatcher thread pops, admits and executes
batch t+1 while the completer thread demuxes and settles batch t, over
a bounded in-flight window (`pipeline_window`, default 2).  Admission,
drain, the journal and the gauges read the lock-guarded in-flight
count.

Left to ROADMAP Queue 1 step 13b, with their constructor arguments
raising NotImplementedError unless off: the shape lattice (`lattice`),
the disk executable tier and the fleet-shared warm directory
(`warm_dir`), the telemetry archive and incident capture
(`archive_dir`, `archive_interval_s`, `incident_min_interval_s`), and
session adoption across replicas (`/sessions/adopt`).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import queue as stdqueue
import re
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .accesslog import AccessLog, find_request
from .excache import (
    OBSERVED_WARMUP_FILE,
    ExecutableCache,
    exec_key,
    key_str,
    load_observed_warmup,
    merge_warmup_entries,
    run_warmup,
    save_observed_warmup,
)
from .journal import (
    RequestJournal,
    acquire_lock,
    journal_path,
    release_lock,
)
from .queueing import (
    AdmissionController,
    BatchingPolicy,
    RequestQueue,
    ServeRequest,
    demux,
)

# Luminance-stats quantization grain (buckets of 1/32 in both mu and
# sigma): fine enough that the canonical-stats remap is visually
# indistinguishable from exact stats, coarse enough that same-source
# request streams actually coalesce.
LUMA_BUCKET = 32.0

REQUEST_TIMEOUT_S = 600.0

# Client-supplied X-Request-Id values must be short and safe (they land
# in logs, span attrs, and metrics labels verbatim); anything else is
# ignored and a server id generated instead.
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def _request_id_from_headers(headers) -> str:
    """The request's id: the client's `X-Request-Id` when present and
    well-formed (so a caller can correlate daemon telemetry with its
    own), else a fresh server-generated one."""
    if headers:
        for k, v in headers.items():
            if str(k).lower() == "x-request-id" \
                    and isinstance(v, str) and _REQUEST_ID_RE.match(v):
                return v
    return uuid.uuid4().hex[:12]


# X-Trace-Hop is a small decimal (the router sends 1; a deeper proxy
# chain counts up).  Anything else is replaced with 1, never rejected.
_TRACE_HOP_RE = re.compile(r"^\d{1,3}$")


def _trace_context_from_headers(headers) -> Dict[str, Any]:
    """Inbound distributed-trace context (round 22): `X-Parent-Span`
    (the upstream hop's span id — the fleet router's, normally) and
    `X-Trace-Hop`.  Returns {} when neither header is present (direct
    untraced traffic pays nothing).  Malformed or oversized values are
    REPLACED with generated/clamped ones and echoed back — the
    round-15 `X-Request-Id` policy: a hostile value must not poison
    logs/span attrs, and a request must never be rejected over
    telemetry decoration."""
    parent = hop = None
    for k, v in (headers or {}).items():
        lk = str(k).lower()
        if lk == "x-parent-span" and isinstance(v, str):
            parent = v
        elif lk == "x-trace-hop" and isinstance(v, str):
            hop = v
    if parent is None and hop is None:
        return {}
    if parent is None or not _REQUEST_ID_RE.match(parent):
        parent = uuid.uuid4().hex[:12]
    hop_n = int(hop) if (hop is not None
                         and _TRACE_HOP_RE.match(hop)) else 1
    return {"parent_span": parent, "hop": hop_n}


def _phase_attribution(req: ServeRequest,
                       total_ms: float) -> Dict[str, float]:
    """queue/compile/execute/demux millis from the request's lifecycle
    events plus its dispatch's prologue wall — the critical-path split
    the access log carries and `ia-synth trace` renders.

    Definitions (all relative offsets from enqueue, so they tile):
      queue_ms   = enqueue -> admitted
      compile_ms = the dispatch's prologue wall (0 when none carried),
                   clamped into the execution window: the port
                   compiles nothing per shape, and the prologue is
                   where a cold shape's first-use costs land
      execute_ms = cache-verdict -> executed, minus compile_ms
      demux_ms   = executed -> the response (demux + settle + handler
                   wakeup — everything after the engine returned)
    The parts deliberately sum to total_ms minus only the sub-ms
    admitted -> cache-verdict preamble, which is what lets the trace
    CLI assert its 5%% reconstruction bound."""
    t = {ev["name"]: ev["t_ms"] for ev in req.spans}
    out: Dict[str, float] = {}
    if "admitted" in t:
        out["queue_ms"] = round(t["admitted"], 3)
    verdict = t.get("cache-hit", t.get("compiled"))
    executed = t.get("executed")
    if executed is not None and verdict is not None:
        window = max(0.0, executed - verdict)
        c = min(float(req.compile_ms or 0.0), window)
        out["compile_ms"] = round(c, 3)
        out["execute_ms"] = round(window - c, 3)
        out["demux_ms"] = round(max(0.0, total_ms - executed), 3)
    return out


def _luma_bucket(frame: np.ndarray) -> Optional[Tuple[float, float]]:
    """(mu, sigma) of the frame's luminance, quantized to LUMA_BUCKET
    bucket CENTERS — the canonical statistics this request will be
    remapped under (and batched by)."""
    if frame.ndim == 3 and frame.shape[2] == 3:
        y = (
            0.299 * frame[..., 0] + 0.587 * frame[..., 1]
            + 0.114 * frame[..., 2]
        )
    else:
        y = frame[..., 0] if frame.ndim == 3 else frame
    mu, sigma = float(np.mean(y)), float(np.std(y))
    # Python floats: the remap takes them as scalars beside its tensors.
    return (
        float((np.floor(mu * LUMA_BUCKET) + 0.5) / LUMA_BUCKET),
        float((np.floor(sigma * LUMA_BUCKET) + 0.5) / LUMA_BUCKET),
    )



_LOG = logging.getLogger("image_analogies_tpu_torch")

# Constructor arguments of parts still to port, with their off values.
_STEP_13B = {
    "lattice": None,
    "warm_dir": None,
    "archive_dir": None,
    "archive_interval_s": 30.0,
    "incident_min_interval_s": 60.0,
}


class SynthDaemon:
    """The daemon: queue + dispatcher + executable cache + HTTP front
    end, all instrumented into one injected registry.

    `start()` binds the live-telemetry server with the serving routes
    mounted and starts the dispatcher and completer threads; `warmup()`
    dispatches the manifest's shapes; `stop()` drains.  The caller owns
    process-level wiring (installing the registry as process default so
    the kernels' counters land in it, flight-recorder signal hooks,
    live.json announcement): cli.cmd_serve is the reference harness."""

    def __init__(
        self,
        a,
        ap,
        cfg,
        *,
        registry,
        tracer=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 25.0,
        max_queue_depth: int = 32,
        cache_capacity: int = 8,
        max_retries: int = 1,
        max_sessions: int = 16,
        flight=None,
        work_dir: Optional[str] = None,
        observability: bool = True,
        access_log_path: Optional[str] = None,
        slo_window_s: float = 300.0,
        state_dir: Optional[str] = None,
        drain_deadline_s: float = 30.0,
        dispatch_deadline_s: Optional[float] = None,
        pipeline_window: int = 2,
        warmup_workers: int = 4,
        obs_interval_s: float = 5.0,
        obs_capacity: int = 120,
        anomaly_config=None,
        **unported,
    ):
        from ..models.analogy import resolve_device
        from ..telemetry.anomaly import AnomalyDetector
        from ..telemetry.slo import SloEngine
        from ..telemetry.timeseries import TimeSeriesRing

        for name, value in unported.items():
            if name not in _STEP_13B:
                raise TypeError(
                    f"SynthDaemon() got an unexpected keyword argument "
                    f"{name!r}"
                )
            if value != _STEP_13B[name]:
                raise NotImplementedError(
                    f"SynthDaemon({name}=...) is not ported to the "
                    "PyTorch package yet: ROADMAP Queue 1 step 13b"
                )
        # A "cuda" daemon without a card refuses here, before binding.
        resolve_device(cfg)
        self.a = np.asarray(a, np.float32)
        self.ap = np.asarray(ap, np.float32)
        self.cfg = cfg
        self.registry = registry
        self.tracer = tracer
        self.flight = flight
        self.policy = BatchingPolicy(
            max_batch=1 if max_batch is None else max_batch,
            max_wait_ms=max_wait_ms,
        )
        self.admission = AdmissionController(
            max_depth=max_queue_depth, registry=registry
        )
        self.cache = ExecutableCache(
            capacity=cache_capacity, registry=registry
        )
        self.queue = RequestQueue()
        self.max_retries = int(max_retries)
        if max_sessions < 1:
            raise ValueError(
                f"max_sessions must be >= 1 ({max_sessions})"
            )
        self.max_sessions = int(max_sessions)
        # session_id -> video.VideoStream, LRU-evicted at capacity.
        # Touched only by the dispatcher thread (routes read len()).
        self._sessions: "OrderedDict[str, Any]" = OrderedDict()
        self.host = host
        self._requested_port = port
        self.live = None  # LiveTelemetryServer after start()
        self._work_dir = work_dir
        self._own_work_dir = work_dir is None
        # True in-flight REQUEST count, summed across every dispatched-
        # but-unsettled batch: admission control, drain, and the
        # inflight gauge all read it.  Lock-guarded because admit runs
        # on the dispatcher thread and settle on the completer.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Admitted requests not yet answered, wherever they are: in the
        # handler's journal append, queued, popped and waiting for a
        # window slot, or in flight.  Admission decides on it and books
        # it under one lock.  (The reference decides on queue depth +
        # in flight, which misses the first and third places: on the
        # card, 24 clients of 1024^2 frames all got in past a limit of
        # 8 while their journal appends ran.)
        self._backlog = 0
        self._admit_lock = threading.Lock()
        self._stop = threading.Event()
        self._dispatcher: Optional[threading.Thread] = None
        # Pipelined dispatch: the dispatcher acquires one window slot
        # per batch, runs the engine, and hands the batch's settle
        # closure (demux + counters + done) to the completer thread,
        # which releases the slot.  Window 1 serializes dispatches.
        if pipeline_window < 1:
            raise ValueError(
                f"pipeline_window must be >= 1 ({pipeline_window})"
            )
        self.pipeline_window = int(pipeline_window)
        self.warmup_workers = int(warmup_workers)
        self._window = threading.BoundedSemaphore(self.pipeline_window)
        self._settle_q: "stdqueue.Queue" = stdqueue.Queue()
        self._completer: Optional[threading.Thread] = None
        self._pipeline_busy = 0
        # Per-request span trees + run-subtree tracer + structured
        # access log, all gated on ONE switch so a bare arm is
        # bit-identical.  (The request-duration histogram and request
        # ids stay on either way: they ARE the response contract.)
        self.observability = bool(observability)
        self._access_log_path = access_log_path
        self.access: Optional[AccessLog] = None
        self.slo = SloEngine(registry, window_s=slo_window_s)
        # Resilience state (inert when state_dir is None except drain,
        # which still quiesces and exits cleanly).
        self.state_dir = state_dir
        self.journal: Optional[RequestJournal] = None
        self.drain_deadline_s = float(drain_deadline_s)
        self.dispatch_deadline_s = dispatch_deadline_s
        self._draining = threading.Event()
        self.drained = threading.Event()
        # Handler threads currently building/writing a response for an
        # ADMITTED request: drain waits for this to reach zero so
        # in-flight responses complete before the process exits.
        self._outstanding = 0
        self._outstanding_lock = threading.Lock()
        # Runtime-observed frame shapes, LRU order: snapshotted to
        # warmup.observed.json and merged into the successor's warmup.
        self._observed_shapes: "OrderedDict[Tuple[int, ...], None]" = \
            OrderedDict()
        # Observatory: windowed time-series ring + live anomaly
        # watches, sampled on one daemon thread.  Interval <= 0
        # disables the plane; evaluation never runs on the request
        # hot path.
        self.obs: Optional[TimeSeriesRing] = None
        self.anomaly: Optional[AnomalyDetector] = None
        if obs_interval_s > 0:
            self.obs = TimeSeriesRing(
                registry, interval_s=obs_interval_s,
                capacity=obs_capacity,
            )
            self.anomaly = AnomalyDetector(
                self.obs, registry, config=anomaly_config,
                max_queue_depth=max_queue_depth,
            )
        self._dispatch_seq = 0  # client-dispatch ordinal (fault keys)
        # request_id -> {"sha256", "shape"} for replayed requests; the
        # takeover check reads it from GET /journal to assert replay
        # bit-identity against the original acked responses.
        self._replayed: Dict[str, Dict[str, Any]] = {}
        self._init_metrics()

    # ------------------------------------------------------- metrics
    def _init_metrics(self) -> None:
        r = self.registry
        self._c_requests = r.counter(
            "ia_serve_requests_total",
            "well-formed synthesis requests received (before the "
            "admission decision; booked first so admitted + shed can "
            "never outrun it)",
        )
        self._c_admitted = r.counter(
            "ia_serve_admitted_total", "requests admitted to the queue"
        )
        self._c_shed = r.counter(
            "ia_serve_shed_total",
            "requests shed with 429 + Retry-After (admission control)",
        )
        self._c_completed = r.counter(
            "ia_serve_completed_total", "requests answered 200"
        )
        self._c_failed = r.counter(
            "ia_serve_failed_total",
            "admitted requests answered 5xx (supervisor give-up or "
            "dispatch error)",
        )
        self._c_cancelled = r.counter(
            "ia_serve_cancelled_total",
            "admitted requests retired before dispatch (client socket "
            "gone or client deadline already blown in the queue) — a "
            "ledger outcome, not an availability failure",
        )
        self._c_dispatches = r.counter(
            "ia_serve_dispatches_total",
            "batch dispatches onto the engine, by kind "
            "(client/warmup); every dispatch consults the executable "
            "cache exactly once",
        )
        self._g_depth = r.gauge(
            "ia_serve_queue_depth", "requests waiting in the queue"
        )
        self._g_inflight = r.gauge(
            "ia_serve_inflight",
            "requests inside dispatched-but-unsettled batches (summed "
            "across the pipeline window)",
        )
        self._g_pipeline = r.gauge(
            "ia_serve_pipeline_inflight_batches",
            "dispatched-but-unsettled batches (pipelined-dispatch "
            "window occupancy; bounded by pipeline_window)",
        )
        self._h_latency = r.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms): queued "
            "= enqueue->admitted, service = admitted->done, total = "
            "enqueue->done",
        )
        from ..telemetry.slo import (
            REQUEST_DURATION_BUCKETS,
            REQUEST_DURATION_METRIC,
        )

        # The SLO engine's raw material: one observation per request
        # at response time, labelled with outcome and cache verdict.
        self._h_duration = r.histogram(
            REQUEST_DURATION_METRIC,
            "end-to-end request latency (ms) by route/outcome/cache — "
            "the raw family the SLO objectives are evaluated from",
            buckets=REQUEST_DURATION_BUCKETS,
        )
        self._g_shape_card = r.gauge(
            "ia_serve_shape_cardinality",
            "distinct client frame shapes observed (LRU-bounded at "
            "32), split into view=raw (as sent) and view=bucketed "
            "(post-lattice) cells; the unlabeled cell follows the "
            "bucketed series — the anomaly detector's shape-growth "
            "watch input (raw == bucketed with no lattice)",
        )
        self._g_depth.set(0)
        self._g_inflight.set(0)
        self._g_pipeline.set(0)
        self._g_shape_card.set(0)
        self._g_shape_card.set(0, labels={"view": "raw"})
        self._g_shape_card.set(0, labels={"view": "bucketed"})

    # ------------------------------------------------------ lifecycle
    def start(self) -> "SynthDaemon":
        from ..telemetry.live import LiveTelemetryServer
        from ..telemetry.spans import as_tracer

        if self.tracer is None:
            self.tracer = as_tracer(None)
        if self._own_work_dir:
            self._work_dir = tempfile.mkdtemp(prefix="ia-serve-")
        if self.state_dir is not None:
            # Lock FIRST (refuses when another live daemon holds the
            # dir), then open the journal, which scans surviving
            # entries into the pending ledger.
            os.makedirs(self.state_dir, exist_ok=True)
            acquire_lock(self.state_dir)
            self.journal = RequestJournal(
                journal_path(self.state_dir), registry=self.registry
            )
        if self.observability:
            self.access = AccessLog(
                self._access_log_path
                or os.path.join(self._work_dir, "access.jsonl")
            )
        self.live = LiveTelemetryServer(
            self.tracer,
            self.registry,
            port=self._requested_port,
            host=self.host,
            flight=self.flight,
            health_cb=self.health,
            routes={
                ("POST", "/synthesize"): self._route_synthesize,
                ("GET", "/serving"): self._route_serving,
                ("GET", "/slo"): self._route_slo,
                ("GET", "/journal"): self._route_journal,
                ("GET", "/obs/window"): self._route_obs_window,
                ("GET", "/request"): self._route_request,
                ("POST", "/drain"): self._route_drain,
            },
        ).start()
        if self.obs is not None:
            # Anomaly evaluation rides the sampler tick (never the
            # request path), so /healthz and the status gauges are at
            # most one interval stale.
            self.obs.start_sampler(on_tick=self._obs_tick)
        self._completer = threading.Thread(
            target=self._completer_loop, name="ia-serve-complete",
            daemon=True,
        )
        self._completer.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="ia-serve-dispatch",
            daemon=True,
        )
        self._dispatcher.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.obs is not None:
            self.obs.stop_sampler()
        for req in self.queue.drain():
            req.status = "failed"
            if self._draining.is_set() and self.journal is not None \
                    and not req.replay:
                # Drain deadline expired with this request still
                # queued: its journal entry stays PENDING so the
                # takeover successor replays it.
                req.error = ("daemon drained before dispatch; "
                             "journaled for takeover replay")
                req.journal_keep = True
            else:
                req.error = "daemon shutting down"
            self._c_failed.inc()
            self._retire(req)
            req.done.set()
        self._g_depth.set(0)
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=30.0)
            self._dispatcher = None
        if self._completer is not None:
            # Sentinel AFTER the dispatcher joined: every settle
            # closure it enqueued is already in the queue, so FIFO
            # order settles them all before the completer exits.
            self._settle_q.put(None)
            self._completer.join(timeout=30.0)
            self._completer = None
        if self.live is not None:
            self.live.stop()
            self.live = None
        if self.access is not None:
            self.access.close()
            self.access = None
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if self.state_dir is not None:
            release_lock(self.state_dir)
        if self._own_work_dir and self._work_dir:
            shutil.rmtree(self._work_dir, ignore_errors=True)

    @property
    def url(self) -> str:
        return self.live.url

    # -------------------------------------------------------- warmup
    def warmup(self, entries: List[Dict[str, Any]]) -> List[Dict]:
        """Dispatch the manifest's shapes through the real dispatch
        path BEFORE announcing the endpoint (cli.cmd_serve orders it
        so): rendezvous implies warm.  With a state dir the manifest is
        merged with the RUNTIME-OBSERVED shapes of warmup.observed.json,
        the fix for manifest drift.  Distinct shapes warm concurrently
        on `warmup_workers` threads, with per-shape walls on the warmup
        span tree (run_warmup's docstring)."""
        if self.state_dir is not None:
            entries = merge_warmup_entries(
                entries, load_observed_warmup(self.observed_warmup_path),
            )

        def dispatch(shape):
            frame = np.zeros(shape, np.float32)
            req = self._make_request(frame)
            self._execute([req], kind="warmup")
            if req.status != "ok":
                raise RuntimeError(
                    f"warmup dispatch failed for shape {shape}: "
                    f"{req.error}"
                )

        def key_fn(shape):
            return exec_key(tuple(shape), self.cfg, self.policy.max_batch)

        return run_warmup(
            entries, dispatch, self.cache, key_fn,
            max_workers=self.warmup_workers,
            tracer=self.tracer if self.observability else None,
        )

    # ------------------------------------------------------- serving
    def _make_request(self, frame: np.ndarray,
                      session: Optional[str] = None,
                      req_id: Optional[str] = None) -> ServeRequest:
        # Session dispatches run one frame at a time through the
        # stream, so their cache identity is the batch-1 grain, not
        # the daemon's padding grain.
        grain = 1 if session is not None else self.policy.max_batch
        key = exec_key(frame.shape, self.cfg, grain)
        bucket = None
        if self.cfg.color_mode == "luminance" and \
                self.cfg.luminance_remap:
            bucket = _luma_bucket(frame)
        kwargs = {"req_id": req_id} if req_id else {}
        return ServeRequest(
            frame=frame, key=key, compat=key + (bucket, session),
            b_stats=bucket, session=session, **kwargs,
        )

    def _route_synthesize(self, body: Optional[bytes], headers=None,
                          ctx=None):
        """POST /synthesize handler (runs on an HTTP handler thread):
        assign/accept the request id -> validate -> admit-or-shed ->
        journal -> enqueue -> block on completion.  Every exit echoes
        `request_id` in the body (the machine-parseable error
        contract), books the `ia_request_duration_ms` cell for its
        outcome, and appends the structured access-log line.

        Round 22: inbound trace context (`X-Parent-Span`/
        `X-Trace-Hop`, forwarded by the fleet router) is validated
        here — malformed values replaced, never rejected — echoed on
        EVERY exit body alongside `request_id`, and recorded on the
        request's `serve_request` span root so the router's
        `route_request` tree and this one join by id."""
        rid = _request_id_from_headers(headers)
        tctx = _trace_context_from_headers(headers)
        t_in = time.monotonic()
        bytes_in = len(body) if body else 0
        try:
            manifest = _parse_manifest(body)
            frame = _frame_from_manifest(manifest)
            session = _session_from_manifest(manifest)
            deadline_ms = _deadline_from_manifest(manifest)
        except ValueError as e:
            payload = _json_bytes({
                "status": "rejected", "error": str(e),
                "request_id": rid, **tctx,
            })
            self._book_response(
                rid, None, "rejected", 400,
                (time.monotonic() - t_in) * 1000.0, bytes_in,
                len(payload), trace=tctx,
            )
            return 400, payload, "application/json"
        if self._draining.is_set():
            # Refused BEFORE the requests counter: the admission
            # ledger (requests == admitted + shed) covers only
            # requests the daemon actually triaged.  `unavailable` is
            # excluded from the SLO availability denominator exactly
            # like shed — a planned drain must not burn error budget.
            retry = max(1.0, round(self.drain_deadline_s, 1))
            payload = _json_bytes({
                "status": "unavailable",
                "error": "daemon is draining; retry against the "
                         "successor",
                "request_id": rid,
                "retry_after_s": retry,
                **tctx,
            })
            self._book_response(
                rid, None, "unavailable", 503,
                (time.monotonic() - t_in) * 1000.0, bytes_in,
                len(payload), trace=tctx,
            )
            return (
                503, payload, "application/json",
                {"Retry-After": str(int(np.ceil(retry)))},
            )
        req = self._make_request(frame, session, req_id=rid)
        if tctx:
            req.trace_parent = tctx.get("parent_span")
            req.trace_hop = tctx.get("hop")
        if deadline_ms is not None:
            req.deadline_t = t_in + deadline_ms / 1000.0
        if ctx is not None:
            req.alive = ctx.get("alive")
        req.span("queued")
        # Requests books FIRST (the serving sentinel check's ordering
        # contract), then exactly one of admitted/shed.
        self._c_requests.inc()
        shed_error = ("shed by admission control (queue at "
                      "capacity); retry after retry_after_s")
        with self._admit_lock:
            inflight = self._inflight
            waiting = max(0, self._backlog - inflight)
            ok, retry_after = self.admission.admit(waiting, inflight)
            if ok and not self.admission.deadline_permits(
                    req.deadline_t, waiting, inflight):
                # Deadline pricing: admitting work whose deadline the
                # queue-depth x p50-service estimate already blows just
                # burns a dispatch on an answer nobody is waiting for.
                ok = False
                retry_after = self.admission.retry_after(
                    waiting + inflight)
                shed_error = ("shed at admission: client deadline "
                              "cannot be met at current queue depth")
            if ok:
                self._backlog += 1
                req.backlogged = True
        if not ok:
            self._c_shed.inc()
            payload = _json_bytes({
                "status": "shed",
                "error": shed_error,
                "request_id": rid,
                "retry_after_s": retry_after,
                **tctx,
            })
            self._book_response(
                rid, req, "shed", 429,
                (time.monotonic() - t_in) * 1000.0, bytes_in,
                len(payload), trace=tctx,
            )
            return (
                429, payload, "application/json",
                {"Retry-After": str(int(np.ceil(retry_after)))},
            )
        self._c_admitted.inc()
        self._note_observed_shape(manifest)
        if self.journal is not None:
            self.journal.append(rid, manifest)
            from ..runtime import faults

            # serve_crash: the chaos harness's hard-kill window —
            # the request is durably journaled but NOT yet enqueued
            # or acknowledged; a takeover must replay it.  Keyed by
            # the journal append ordinal.
            if faults.fire(
                "serve_crash", self.journal.appended - 1
            ) == "fail":
                os._exit(137)
        with self._outstanding_lock:
            self._outstanding += 1
        try:
            return self._await_response(
                rid, req, t_in, bytes_in, tctx
            )
        finally:
            with self._outstanding_lock:
                self._outstanding -= 1

    def _await_response(self, rid: str, req: ServeRequest,
                        t_in: float, bytes_in: int,
                        tctx: Optional[Dict[str, Any]] = None):
        """The admitted request's wait-and-respond tail, under the
        drain machinery's outstanding-responses counter (graceful
        drain waits for this to return before snapshotting state and
        exiting — an in-flight response is never cut mid-write)."""
        tctx = tctx or {}
        self.queue.put(req)
        self._g_depth.set(len(self.queue))
        if not req.done.wait(REQUEST_TIMEOUT_S):
            # The client gives up, but the request is still queued or
            # in flight: the DISPATCHER still owns its ledger entry
            # and will book completed/failed when it settles — booking
            # failed here too would double-count the admission ledger
            # the serving sentinel check balances.
            req.error = "request timed out in the daemon"
            payload = _json_bytes({
                "status": "failed", "request_id": rid,
                "error": req.error, **tctx,
            })
            self._book_response(
                rid, req, "timeout", 504,
                (time.monotonic() - req.enqueue_t) * 1000.0, bytes_in,
                len(payload), trace=tctx,
            )
            return 504, payload, "application/json"
        total_ms = (time.monotonic() - req.enqueue_t) * 1000.0
        self._h_latency.observe(total_ms, labels={"phase": "total"})
        if req.status == "cancelled":
            # Retired before dispatch (socket gone / deadline blown in
            # queue).  499 after nginx's "client closed request"; the
            # body exists for the rare still-listening client.
            payload = _json_bytes({
                "status": "cancelled", "request_id": rid,
                "error": req.error, **tctx,
            })
            self._book_response(
                rid, req, "cancelled", 499, total_ms, bytes_in,
                len(payload), trace=tctx,
            )
            return 499, payload, "application/json"
        if req.status != "ok":
            payload = _json_bytes({
                "status": "failed", "request_id": rid,
                "error": req.error, "spans": req.spans, **tctx,
            })
            self._book_response(
                rid, req, "failed", 500, total_ms, bytes_in,
                len(payload), trace=tctx,
            )
            return 500, payload, "application/json"
        out = np.asarray(req.result, np.float32)
        payload = _json_bytes({
            "status": "ok",
            "request_id": rid,
            **tctx,
            "cache": req.cache,
            "batch_size": req.batch_size,
            "wall_ms": round(total_ms, 3),
            "spans": req.spans,
            "shape": list(out.shape),
            "dtype": "float32",
            "image_b64": base64.b64encode(
                np.ascontiguousarray(out).tobytes()
            ).decode(),
        })
        self._book_response(
            rid, req, "ok", 200, total_ms, bytes_in, len(payload),
            trace=tctx,
        )
        return 200, payload, "application/json"

    def _book_response(self, rid: str, req: Optional[ServeRequest],
                       outcome: str, code: int, total_ms: float,
                       bytes_in: int, bytes_out: int,
                       trace: Optional[Dict[str, Any]] = None) -> None:
        """Response-time bookkeeping, one call per exit path: the
        request-duration observation (always — it is the SLO engine's
        raw material) and the access-log line (observability only).
        Also the journal's `done` mark — a response write IS what
        retires a journal entry (cancellation marks happen at the
        dispatcher, and drain-stranded requests skip the mark via
        `journal_keep` so the successor still replays them)."""
        if (
            self.journal is not None and req is not None
            and not req.replay
            and outcome in ("ok", "failed", "timeout")
            and not getattr(req, "journal_keep", False)
        ):
            self.journal.mark(rid, "done")
        cache = req.cache if req is not None and req.cache else "none"
        # The request id rides as the bucket's exemplar (round 19):
        # a latency-spike bucket in the exposition names the exact
        # request to `ia-synth trace`.
        self._h_duration.observe(total_ms, labels={
            "route": "/synthesize", "outcome": outcome, "cache": cache,
        }, exemplar=rid)
        if self.access is None:
            return
        entry: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "request_id": rid,
            "route": "/synthesize",
            "outcome": outcome,
            "http_status": code,
            "total_ms": round(total_ms, 3),
            "bytes_in": bytes_in,
            "bytes_out": bytes_out,
        }
        if trace:
            entry["parent_span"] = trace.get("parent_span")
            entry["hop"] = trace.get("hop")
        if req is not None:
            entry["t0"] = round(req.t0, 6)
            entry["session_id"] = req.session
            entry["exec_key"] = key_str(req.key)
            entry["cache"] = req.cache
            entry["batch_size"] = req.batch_size
            entry.update(_phase_attribution(req, total_ms))
        self.access.log(entry)

    def _route_slo(self, _body):
        """GET /slo: grade the declarative objectives over the sliding
        window and publish the burn-rate gauges — evaluation happens
        HERE (pull), never on the request hot path.  With the round-19
        observatory on, the live anomaly report rides along under
        `anomalies` so one scrape answers both "is the budget burning"
        and "is something anomalous right now"."""
        report = self.slo.evaluate()
        if self.anomaly is not None:
            report["anomalies"] = self.anomaly.evaluate()
        return 200, _json_bytes(report), "application/json"

    def _route_obs_window(self, _body, _headers, ctx):
        """GET /obs/window?span=S: the time-series ring's windowed
        view (rates + windowed quantiles) over the last S seconds
        (omitted = the whole ring)."""
        if self.obs is None:
            return 404, _json_bytes({
                "error": "observatory disabled (obs_interval_s <= 0)",
            }), "application/json"
        raw = (ctx.get("query") or {}).get("span")
        span = None
        if raw not in (None, ""):
            try:
                span = float(raw)
                if span <= 0:
                    raise ValueError
            except ValueError:
                return 400, _json_bytes({
                    "error": f"span must be a positive number "
                             f"of seconds, got {raw!r}",
                }), "application/json"
        return 200, _json_bytes(self.obs.window(span)), \
            "application/json"

    def _obs_tick(self) -> None:
        """The sampler tick: grade the anomaly watches (the archive's
        snapshot and incident trigger are ROADMAP Queue 1 step 13b).
        Never the request hot path."""
        if self.anomaly is not None:
            self.anomaly.evaluate()

    def _route_request(self, _body, _headers, ctx):
        """GET /request?id=<request_id>: one request's access-log
        record + its flight-recorder events, live over HTTP — the
        `ia-synth trace <id> --url` backend (post-mortem trace reads
        artifacts; this answers while the daemon still runs).  404
        with a JSON error on an unknown id."""
        rid = (ctx.get("query") or {}).get("id")
        if not rid:
            return 400, _json_bytes({
                "error": "missing required query parameter: id",
            }), "application/json"
        entry = None
        if self.access is not None:
            entry = find_request(self.access.path, rid)
        if entry is None:
            return 404, _json_bytes({
                "error": f"request id {rid!r} not found"
                + ("" if self.access is not None
                   else " (access log disabled)"),
                "request_id": rid,
            }), "application/json"
        events = []
        if self.flight is not None:
            from ..telemetry.flight import tree_events

            # Whole-tree events (round 22): the serve_request root
            # plus its lifecycle/run children, so the fleet waterfall
            # can nest the replica's inner spans inside the router's
            # proxy window without a second scrape.
            events = tree_events(self.flight.to_dict(), rid)
        return 200, _json_bytes({
            "request": entry, "flight_events": events,
        }), "application/json"

    def _route_serving(self, _body):
        """GET /serving: the operator's one-look snapshot — queue /
        in-flight occupancy, cache residency, and the SLO quantiles.
        `disk_cache` and `lattice` stay null until ROADMAP Queue 1
        step 13b."""
        snap = {
            "queue_depth": len(self.queue),
            "inflight": self._inflight,
            "backlog": self._backlog,
            "draining": self._draining.is_set(),
            "state_dir": self.state_dir,
            "warm_dir": None,
            "policy": {
                "max_batch": self.policy.max_batch,
                "max_wait_ms": self.policy.max_wait_ms,
                "max_queue_depth": self.admission.max_depth,
                "effective_queue_depth": self.admission.effective_depth(),
            },
            "pipeline": {
                "window": self.pipeline_window,
                "inflight_batches": self._pipeline_busy,
            },
            "cache": self.cache.snapshot(),
            "disk_cache": None,
            "lattice": None,
            "sessions": {
                "active": len(self._sessions),
                "max": self.max_sessions,
                "frames": {
                    sid: stream.t
                    for sid, stream in self._sessions.items()
                },
            },
            "slo_ms": {
                phase: {
                    "p50": self._h_latency.quantile(
                        0.5, labels={"phase": phase}
                    ),
                    "p99": self._h_latency.quantile(
                        0.99, labels={"phase": phase}
                    ),
                }
                for phase in ("queued", "service", "total")
            },
        }
        return 200, _json_bytes(snap), "application/json"

    def _route_journal(self, _body):
        """GET /journal: the durability ledger — journal counts, the
        drain state machine's position, and the replay record (rid ->
        output sha256) a takeover successor accumulates.  The chaos
        harness asserts zero acked loss and replay bit-identity from
        exactly this snapshot."""
        snap = {
            "ledger": (self.journal.counts()
                       if self.journal is not None else None),
            "state_dir": self.state_dir,
            "draining": self._draining.is_set(),
            "drained": self.drained.is_set(),
            "replayed": dict(self._replayed),
        }
        return 200, _json_bytes(snap), "application/json"

    def _route_drain(self, _body):
        """POST /drain: flip to draining (idempotent) and return
        immediately — 202, the drain worker finishes asynchronously.
        New requests now get 503 + Retry-After; `drained` flips once
        in-flight work and response writes are settled and the
        hand-off state is on disk."""
        already = self._draining.is_set()
        self.begin_drain(reason="drain")
        payload = {
            "status": "draining",
            "already_draining": already,
            "queue_depth": len(self.queue),
            "inflight": self._inflight,
            "drain_deadline_s": self.drain_deadline_s,
        }
        return 202, _json_bytes(payload), "application/json"

    # ------------------------------------------------ drain machinery
    def begin_drain(self, reason: str = "drain") -> None:
        """Enter draining (idempotent): refuse new work, let queued +
        in-flight requests and their response writes finish under
        `drain_deadline_s`, snapshot hand-off state, set `drained`.
        The caller (cli.cmd_serve's SIGTERM handler / main loop)
        decides when to actually exit."""
        if self._draining.is_set():
            return
        self._draining.set()
        _LOG.warning(
            "serving drain started (reason=%s, queue=%d, inflight=%d)",
            reason, len(self.queue), self._inflight,
        )
        t = threading.Thread(
            target=self._drain_worker, name="ia-serve-drain",
            daemon=True,
        )
        t.start()

    def _drain_worker(self) -> None:
        deadline = time.monotonic() + self.drain_deadline_s
        while time.monotonic() < deadline:
            with self._outstanding_lock:
                outstanding = self._outstanding
            if (len(self.queue) == 0 and self._inflight == 0
                    and outstanding == 0):
                break
            time.sleep(0.02)
        # A breath for the HTTP server threads to push the last
        # payloads through their sockets (handlers return bytes; the
        # server writes them just after).
        time.sleep(0.1)
        try:
            self._drain_snapshot()
        except Exception:  # noqa: BLE001 - drain must terminate
            _LOG.exception("drain snapshot failed (continuing to exit)")
        if self.flight is not None:
            try:
                # Sticky "drain" label: distinguishes a graceful
                # hand-off dump from a SIGTERM dump.
                self.flight.flush(reason="drain")
            except Exception:  # noqa: BLE001
                pass
        self.drained.set()

    def _drain_snapshot(self) -> None:
        """Persist the hand-off state a takeover successor restores:
        every resident session's carried state (session ids are hashed
        into dir names: they are client-chosen strings, not safe path
        components), the runtime-observed shapes, and finally the
        journal's pending-only compaction.  Sessions first: the
        compaction is the one destructive step, so a kill inside this
        function leaves either the old journal intact or the full
        snapshot plus a compacted journal."""
        if self.state_dir is None:
            return
        import hashlib

        index: Dict[str, str] = {}
        for sid, stream in self._sessions.items():
            dirname = hashlib.sha1(sid.encode()).hexdigest()[:16]
            sdir = os.path.join(self.state_dir, "sessions", dirname)
            try:
                stream.save_state(sdir)
                index[sid] = dirname
            except Exception:  # noqa: BLE001 - skip broken streams
                _LOG.exception("session %s snapshot failed (skipped)", sid)
        tmp = os.path.join(self.state_dir, "sessions.json.tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"schema_version": 1, "sessions": index}, fh)
        os.replace(tmp, os.path.join(self.state_dir, "sessions.json"))
        self._save_observed_shapes()
        if self.journal is not None:
            self.journal.compact()

    # --------------------------------------------- takeover machinery
    @property
    def observed_warmup_path(self) -> Optional[str]:
        if self.state_dir is None:
            return None
        return os.path.join(self.state_dir, OBSERVED_WARMUP_FILE)

    @staticmethod
    def _lru_note(lru: "OrderedDict", key, cap: int = 32) -> bool:
        """Insert/refresh `key` in an LRU set bounded at `cap`;
        True when the key was fresh."""
        fresh = key not in lru
        lru[key] = None
        lru.move_to_end(key)
        while len(lru) > cap:
            lru.popitem(last=False)
        return fresh

    def _note_observed_shape(self, manifest: Dict[str, Any]) -> None:
        """LRU-track the (H, W, C) shapes real clients send; persisted
        on first sighting and at drain so the successor's warmup
        dispatches what traffic actually needs, not what the manifest
        author guessed.  With no lattice the raw and bucketed
        cardinality cells are one series."""
        shape = manifest.get("shape")
        if not (isinstance(shape, list) and len(shape) == 3):
            return
        fresh = self._lru_note(
            self._observed_shapes, tuple(int(d) for d in shape)
        )
        card = len(self._observed_shapes)
        self._g_shape_card.set(card)
        self._g_shape_card.set(card, labels={"view": "raw"})
        self._g_shape_card.set(card, labels={"view": "bucketed"})
        if fresh and self.state_dir is not None:
            try:
                self._save_observed_shapes()
            except OSError:
                pass

    def _save_observed_shapes(self) -> None:
        if self.state_dir is None or not self._observed_shapes:
            return
        save_observed_warmup(
            self.observed_warmup_path, list(self._observed_shapes),
        )

    def restore_sessions(self) -> int:
        """Takeover: re-open every session stream the predecessor
        snapshotted at drain.  Best-effort — a session that fails to
        restore simply runs its next frame cold."""
        if self.state_dir is None:
            return 0
        from ..video.sequence import VideoStream

        idx_path = os.path.join(self.state_dir, "sessions.json")
        try:
            with open(idx_path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return 0
        sessions = doc.get("sessions")
        if not isinstance(sessions, dict):
            return 0
        cfg = dataclasses.replace(self.cfg, save_level_artifacts=None)
        n = 0
        for sid, dirname in sessions.items():
            if not (isinstance(sid, str) and isinstance(dirname, str)):
                continue
            sdir = os.path.join(self.state_dir, "sessions",
                                os.path.basename(dirname))
            stream = VideoStream(
                self.a, self.ap, cfg=cfg, registry=self.registry
            )
            if stream.restore_state(sdir):
                self._sessions[sid] = stream
                n += 1
        return n

    def replay_journal(self) -> int:
        """Takeover: push every journal-pending request back through
        the NORMAL queue (replay flag set — no client is waiting; the
        settle path marks them `replayed` and records the output hash
        for the bit-identity audit).  An entry whose manifest no
        longer reconstructs is retired `cancelled` rather than left to
        wedge the ledger forever."""
        if self.journal is None:
            return 0
        n = 0
        for rec in self.journal.pending_entries():
            rid = rec.get("request_id", "")
            try:
                manifest = rec["manifest"]
                frame = _frame_from_manifest(manifest)
                session = _session_from_manifest(manifest)
            except (ValueError, KeyError, TypeError):
                self.journal.mark(rid, "cancelled")
                self._c_cancelled.inc()
                continue
            req = self._make_request(frame, session, req_id=rid)
            req.replay = True
            req.span("queued")
            # Replays walk the whole admission ledger (requests ->
            # admitted -> completed/failed) so every serving-sentinel
            # invariant holds on the successor's registry too.
            self._c_requests.inc()
            self._c_admitted.inc()
            with self._admit_lock:
                self._backlog += 1
                req.backlogged = True
            self.queue.put(req)
            n += 1
        self._g_depth.set(len(self.queue))
        if n:
            _LOG.warning(
                "takeover: replaying %d journaled request(s)", n
            )
        return n

    def health(self) -> Dict[str, Any]:
        """/healthz callback: the full sentinel evaluation (which now
        includes the serving ledger check) against the daemon's
        registry."""
        from ..telemetry.sentinel import evaluate_health

        return evaluate_health(
            metrics=self.registry.to_dict(), context="serving"
        )

    # ---------------------------------------------------- dispatcher
    def _note_pipeline(self, delta: int) -> None:
        with self._inflight_lock:
            self._pipeline_busy = max(0, self._pipeline_busy + delta)
            self._g_pipeline.set(self._pipeline_busy)

    def _completer_loop(self) -> None:
        """Completion stage of the pipelined dispatcher: run each
        batch's settle closure (demux -> counters -> done events) and
        only then release its window slot.  A settle that dies still
        releases the slot and fails its undone requests — a wedged
        completer must degrade to failed requests, never to a daemon
        whose window never reopens."""
        while True:
            item = self._settle_q.get()
            if item is None:
                return
            settle, batch = item
            try:
                settle()
            except BaseException as e:  # noqa: BLE001 - daemon survives
                _LOG.exception(
                    "serving settle error"
                )
                for req in batch:
                    if not req.done.is_set():
                        req.status = "failed"
                        req.error = f"{type(e).__name__}: {e}"
                        self._c_failed.inc()
                        self._retire(req)
                        req.done.set()
            finally:
                self._note_pipeline(-1)
                self._window.release()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            batch = self.queue.next_batch(self.policy, timeout=0.25)
            if batch is None:
                continue
            self._g_depth.set(len(self.queue))
            batch = self._filter_batch(batch)
            if not batch:
                continue
            # One window slot per dispatched batch; timed re-checks so
            # stop() can't be wedged behind a full window.
            acquired = False
            while not self._stop.is_set():
                if self._window.acquire(timeout=0.25):
                    acquired = True
                    break
            if not acquired:
                for req in batch:
                    req.status = "failed"
                    req.error = "daemon shutting down"
                    self._c_failed.inc()
                    self._retire(req)
                    req.done.set()
                continue
            self._note_pipeline(+1)
            deferred: List[Any] = []
            try:
                self._dispatch_guarded(batch, defer=deferred.append)
            except BaseException as e:  # noqa: BLE001 - daemon survives
                _LOG.exception(
                    "serving dispatch error"
                )
                for req in batch:
                    if not req.done.is_set():
                        req.status = "failed"
                        req.error = f"{type(e).__name__}: {e}"
                        self._c_failed.inc()
                        self._retire(req)
                        req.done.set()
            finally:
                if deferred:
                    # Engine work is done; settle (demux + response
                    # fields + done) happens on the completer while
                    # this thread pops the next batch.
                    self._settle_q.put((deferred[0], batch))
                else:
                    # Settle already ran inline (session batch, or an
                    # exception path that must not race the guard
                    # above): the slot frees immediately.
                    self._note_pipeline(-1)
                    self._window.release()

    def _dispatch_guarded(self, batch: List[ServeRequest],
                          defer=None) -> None:
        """Client dispatch under the round-16 guards: the serve_hang /
        serve_evict fault points (keyed by client-dispatch ordinal)
        and, when `dispatch_deadline_s` is set, a DispatchDeadline
        whose abort token is installed on THIS thread — so a wedged
        dispatch (the injected hang, or an engine stall at a `level`
        fire point) unwinds as LevelAborted instead of freezing the
        dispatcher forever."""
        from ..runtime import faults
        from ..runtime.supervisor import DispatchDeadline

        seq = self._dispatch_seq
        self._dispatch_seq += 1
        dd = None
        if self.dispatch_deadline_s:
            dd = DispatchDeadline(self.dispatch_deadline_s).arm()
            faults.set_abort_token(dd.token)
        try:
            faults.fire("serve_hang", seq)
            if faults.fire("serve_evict", seq) == "fail":
                # Forced cache-epoch eviction: the next lookup is an
                # honest miss + recompile, not a wrong answer.
                self.cache.force_epoch_eviction()
            self._execute(batch, kind="client", defer=defer)
        finally:
            if dd is not None:
                dd.cancel()
                faults.set_abort_token(None)

    def _filter_batch(
        self, batch: List[ServeRequest]
    ) -> List[ServeRequest]:
        """Last call before the engine burns a dispatch: drop popped
        requests whose client socket is already gone or whose client
        deadline expired while queued.  Replays are exempt (their
        client is the journal).  Runs on the dispatcher thread, so the
        cancel path owns the ledger entry exactly like settle does."""
        now = time.monotonic()
        keep: List[ServeRequest] = []
        for req in batch:
            if req.replay:
                keep.append(req)
                continue
            if req.alive is not None:
                try:
                    alive = bool(req.alive())
                except Exception:  # noqa: BLE001 - probe never fatal
                    alive = True
                if not alive:
                    self._cancel_request(
                        req, "client disconnected before dispatch"
                    )
                    continue
            if req.deadline_t is not None and now > req.deadline_t:
                self._cancel_request(
                    req, "client deadline expired in queue"
                )
                continue
            keep.append(req)
        return keep

    def _retire(self, req: ServeRequest) -> None:
        """An admitted request leaves the backlog (once, whichever path
        answers it: settle, cancel, failure, shutdown)."""
        with self._admit_lock:
            if getattr(req, "backlogged", False):
                req.backlogged = False
                self._backlog -= 1

    def _cancel_request(self, req: ServeRequest, why: str) -> None:
        req.status = "cancelled"
        req.error = why
        self._c_cancelled.inc()
        if self.journal is not None:
            self.journal.mark(req.req_id, "cancelled")
        self._retire(req)
        req.done.set()

    def _admit_batch(self, batch: List[ServeRequest],
                     kind: str) -> float:
        """Shared dispatch preamble: admission spans/latency, the
        in-flight gauges, the dispatch counter, and the executable-
        cache verdict (booked exactly once per dispatch: the serving
        sentinel's `hits + misses == dispatches` contract).  Returns
        the admission timestamp."""
        admit_t = time.monotonic()
        for req in batch:
            req.span("admitted")
            req.batch_size = len(batch)
            self._h_latency.observe(
                (admit_t - req.enqueue_t) * 1000.0,
                labels={"phase": "queued"},
            )
        with self._inflight_lock:
            self._inflight += len(batch)
            self._g_inflight.set(self._inflight)
        self._c_dispatches.inc(labels={"kind": kind})
        cache_status = self.cache.lookup(
            batch[0].key, kind=kind, request_id=batch[0].req_id
        )
        span_name = "cache-hit" if cache_status == "hit" else "compiled"
        for req in batch:
            req.cache = cache_status
            req.span(span_name)
        return admit_t

    def _settle_batch(self, batch: List[ServeRequest],
                      admit_t: float, run_roots=(),
                      compile_ms: Optional[float] = None) -> None:
        """Shared dispatch epilogue: per-request span trees grafted
        onto the daemon tracer, service latency, done events, and the
        in-flight gauges back to idle.  `compile_ms` (the dispatch's
        prologue wall) is stamped on every co-tenant BEFORE `done`
        fires, so the handler thread's access-log line sees it."""
        for req in batch:
            req.compile_ms = compile_ms
        if self.observability:
            try:
                self._attach_request_trees(batch, run_roots)
            except Exception:  # noqa: BLE001 - never fail the dispatch
                _LOG.exception(
                    "per-request span tree construction failed"
                )
        service_ms = (time.monotonic() - admit_t) * 1000.0
        for req in batch:
            self._h_latency.observe(
                service_ms, labels={"phase": "service"}
            )
            if req.replay:
                self._settle_replay(req)
            self._retire(req)
            req.done.set()
        with self._inflight_lock:
            self._inflight = max(0, self._inflight - len(batch))
            self._g_inflight.set(self._inflight)

    def _settle_replay(self, req: ServeRequest) -> None:
        """A replayed request has no handler thread: the dispatcher
        retires its journal entry here.  Success marks `replayed` and
        records the output sha256 (the chaos harness's bit-identity
        evidence); failure leaves the entry PENDING so the next
        takeover tries again (at-least-once until a response exists
        somewhere)."""
        if req.status != "ok" or req.result is None:
            return
        import hashlib

        out = np.ascontiguousarray(np.asarray(req.result, np.float32))
        self._replayed[req.req_id] = {
            "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
            "shape": list(out.shape),
        }
        if self.journal is not None:
            self.journal.mark(req.req_id, "replayed")

    def _attach_request_trees(self, batch: List[ServeRequest],
                              run_roots) -> None:
        """Convert each request's lifecycle events into ONE real span
        tree — `serve_request` root spanning enqueue -> settle, one
        child interval per lifecycle event (each reaching to the next
        event), the dispatch's run->level subtree grafted under the
        batch LEAD's root (once, not per co-tenant; co-tenants carry a
        `run_in` pointer) — and graft it onto the daemon tracer, where
        the flight recorder, /progress, and check_report already look.
        Runs on the dispatcher thread only, after the dispatch, so the
        tracer's span stack is untouched (module docstring of
        serving/queueing.py: why lifecycle events can't be live
        spans)."""
        if self.tracer is None or not self.tracer.enabled:
            return
        from ..telemetry.spans import span_at

        settle_perf = time.perf_counter()
        lead = batch[0]
        for req in batch:
            base = req.enqueue_perf
            rel_end = (settle_perf - base) * 1000.0
            events = [(ev["name"], float(ev["t_ms"]))
                      for ev in req.spans]
            root = span_at(
                "serve_request", base, settle_perf,
                request_id=req.req_id, session=req.session,
                cache=req.cache, batch_size=req.batch_size,
                outcome=req.status,
            )
            if req.trace_parent is not None:
                # Round-22 join key: the upstream (router) span id —
                # the fleet waterfall matches this against the
                # route_request tree's span_id.
                root.attrs["parent_span"] = req.trace_parent
                root.attrs["hop"] = req.trace_hop
            for i, (name, t_ms) in enumerate(events):
                nxt = (events[i + 1][1] if i + 1 < len(events)
                       else rel_end)
                root.children.append(span_at(
                    name, base + t_ms / 1000.0,
                    base + max(t_ms, nxt) / 1000.0,
                ))
            if req is lead and run_roots:
                root.children.extend(run_roots)
                root.attrs["run_attached"] = len(run_roots)
            elif run_roots:
                root.attrs["run_in"] = lead.req_id
            self.tracer.attach_tree(root)

    def _execute(self, batch: List[ServeRequest],
                 kind: str = "client", defer=None) -> None:
        """One dispatch: cache verdict -> pad to the static grain ->
        supervised `synthesize_batch` -> output to the host -> demux ->
        settle requests.  Session batches (compat pins them to one
        session id) detour through the per-session warm-start stream.

        Pipelining seam: when `defer` is given (the client dispatcher),
        the settle tail (demux, outcome counters, done events) is
        packaged as a closure and handed over instead of run inline, so
        it executes on the completer thread while this thread starts
        the next batch.  The engine call, the copy to the host and the
        `executed` timestamp all stay here, and every exception path
        settles inline before propagating."""
        from ..parallel.batch import synthesize_batch
        from ..runtime.supervisor import SupervisorGaveUp, supervise

        if batch[0].session is not None:
            self._execute_session(batch, kind=kind)
            return

        grain = self.policy.max_batch
        admit_t = self._admit_batch(batch, kind)
        ckpt_dir = None
        run_tracer = None
        out = None
        ok = False
        gaveup = None

        def settle():
            try:
                if ok:
                    demux(batch, out[: len(batch)])
                    for req in batch:
                        if kind == "client":
                            self._c_completed.inc()
                elif gaveup is not None:
                    for req in batch:
                        req.status = "failed"
                        req.error = f"supervisor gave up: {gaveup}"
                        if kind == "client":
                            self._c_failed.inc()
            finally:
                if ckpt_dir is not None:
                    shutil.rmtree(ckpt_dir, ignore_errors=True)
                run_roots, compile_ms = (), None
                if run_tracer is not None:
                    run_roots = tuple(run_tracer.roots)
                    walls = [
                        sp.wall_ms
                        for sp in run_tracer.find("prologue")
                        if sp.wall_ms is not None
                    ]
                    if walls:
                        compile_ms = round(sum(walls), 3)
                self._settle_batch(
                    batch, admit_t, run_roots=run_roots,
                    compile_ms=compile_ms,
                )

        try:
            frames = np.stack([r.frame for r in batch])
            if frames.shape[0] < grain:
                frames = np.concatenate(
                    [frames]
                    + [frames[-1:]] * (grain - frames.shape[0]), axis=0
                )
            b_stats = batch[0].b_stats
            ckpt_dir = tempfile.mkdtemp(
                prefix="dispatch-", dir=self._work_dir
            )
            cfg = dataclasses.replace(
                self.cfg, save_level_artifacts=ckpt_dir
            )
            # Per-dispatch run tracer (observability on): the batch
            # runner's run->level->em_iter tree, grafted under the
            # batch lead's serve_request root at settle.
            # Instrumentation only (the runner never branches numerics
            # on it) and LEAN: it skips the per-level energy readback,
            # so request tracing adds no device sync to the hot path.
            if self.observability and self.tracer is not None \
                    and self.tracer.enabled:
                from ..telemetry.spans import Tracer

                run_tracer = Tracer(lean=True)

            def attempt(resume_from):
                return synthesize_batch(
                    self.a, self.ap, frames, cfg,
                    progress=run_tracer,
                    resume_from=resume_from,
                    frame_indices=[0] * grain,
                    _b_stats=b_stats,
                )

            try:
                out = supervise(
                    attempt,
                    ckpt_dir=ckpt_dir,
                    tracer=None,
                    registry=self.registry,
                    max_retries=self.max_retries,
                    ladder=[],
                    backoff_s=0.05,
                    max_backoff_s=1.0,
                )
                # To the host here, before `executed`: the settle and
                # the handlers touch numpy arrays only.
                out = out.cpu().numpy().astype(np.float32, copy=False)
                for req in batch:
                    req.span("executed")
                ok = True
            except SupervisorGaveUp as e:
                gaveup = e
        except BaseException:
            settle()
            raise
        if defer is not None:
            defer(settle)
        else:
            settle()

    # ---------------------------------------------- session dispatch
    def _session_stream(self, sid: str, proto: ServeRequest):
        """The session's VideoStream, created on first use (remap
        stats pinned to the opening frame's luma bucket) and LRU-
        evicted at `max_sessions`: an evicted session's next frame
        simply opens a new stream and runs cold."""
        stream = self._sessions.get(sid)
        if stream is not None:
            self._sessions.move_to_end(sid)
            return stream
        from ..video.sequence import VideoStream

        cfg = dataclasses.replace(self.cfg, save_level_artifacts=None)
        stream = VideoStream(
            self.a, self.ap, cfg=cfg, b_stats=proto.b_stats,
            registry=self.registry,
        )
        self._sessions[sid] = stream
        while len(self._sessions) > self.max_sessions:
            evicted, _ = self._sessions.popitem(last=False)
            _LOG.info(
                "serving session %s evicted (LRU, %d resident)",
                evicted, len(self._sessions),
            )
        return stream

    def _execute_session(self, batch: List[ServeRequest],
                         kind: str = "client") -> None:
        """One session dispatch: the batch (all one session, by
        compat) steps through the session's warm-start stream in
        arrival order.  No supervisor: a failed step leaves the
        stream's carried state unsettled, so the dispatch fails its
        requests and RESETS the session; the next frame opens a fresh
        stream and runs cold (module docstring)."""
        sid = batch[0].session
        admit_t = self._admit_batch(batch, kind)
        try:
            stream = self._session_stream(sid, batch[0])
            outs = []
            for req in batch:
                outs.append(
                    stream.step(req.frame, request_id=req.req_id)
                    .cpu().numpy().astype(np.float32, copy=False))
            for req in batch:
                req.span("executed")
            demux(batch, outs)
            for req in batch:
                if kind == "client":
                    self._c_completed.inc()
        except BaseException as e:  # noqa: BLE001 - daemon survives
            _LOG.exception(
                "serving session %s dispatch error (session reset)", sid
            )
            self._sessions.pop(sid, None)
            for req in batch:
                if not req.done.is_set():
                    req.status = "failed"
                    req.error = f"{type(e).__name__}: {e}"
                    if kind == "client":
                        self._c_failed.inc()
        finally:
            self._settle_batch(batch, admit_t)


# ------------------------------------------------------------- payloads
def _json_bytes(obj) -> bytes:
    return (json.dumps(obj) + "\n").encode()


def _decode_request(body: Optional[bytes]) -> np.ndarray:
    """Parse a /synthesize payload into one float32 (H, W, C) frame.

    Wire format: JSON {"image_b64": base64 of the raw pixel buffer,
    "shape": [H, W, C], "dtype": "float32"|"uint8", optional
    "session_id": str} — raw buffers rather than PNG so the daemon has
    zero image-codec dependencies on the hot path (uint8 payloads are
    scaled to [0, 1]).  Raises ValueError (-> HTTP 400) on any
    malformation.  (The route handler parses the manifest once and
    pulls frame + session separately; this wrapper is the frame-only
    convenience the tests and warmup path use.)"""
    return _frame_from_manifest(_parse_manifest(body))


def _parse_manifest(body: Optional[bytes]) -> dict:
    if not body:
        raise ValueError("empty request body")
    try:
        manifest = json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"request body is not JSON: {e}") from None
    if not isinstance(manifest, dict):
        raise ValueError("request body is not a JSON object")
    return manifest


def _session_from_manifest(manifest: dict) -> Optional[str]:
    """The optional session-affinity id: a non-empty string of at most
    64 characters (the compat key embeds it verbatim; the bound keeps
    a hostile client from inflating queue snapshots and logs)."""
    sid = manifest.get("session_id")
    if sid is None:
        return None
    if not isinstance(sid, str) or not 1 <= len(sid) <= 64:
        raise ValueError(
            "session_id must be a non-empty string of <= 64 characters"
        )
    return sid


def _deadline_from_manifest(manifest: dict) -> Optional[float]:
    """The optional client deadline budget (`deadline_ms`): how long
    the client will wait for its answer, measured from receipt.  A
    finite positive number of milliseconds (bounded at an hour — a
    'deadline' past REQUEST_TIMEOUT_S is a typo, not a budget)."""
    ms = manifest.get("deadline_ms")
    if ms is None:
        return None
    if isinstance(ms, bool) or not isinstance(ms, (int, float)) \
            or not np.isfinite(ms) or not 0 < ms <= 3_600_000:
        raise ValueError(
            f"deadline_ms {ms!r} is not a positive number of "
            f"milliseconds (<= 3600000)"
        )
    return float(ms)


def _frame_from_manifest(manifest: dict) -> np.ndarray:
    shape = manifest.get("shape")
    if (
        not isinstance(shape, list) or len(shape) != 3
        or not all(isinstance(d, int) and d >= 1 for d in shape)
        or shape[2] not in (1, 3)
    ):
        raise ValueError(
            f"shape {shape!r} is not [H, W, C] with C in (1, 3)"
        )
    dtype = manifest.get("dtype", "float32")
    if dtype not in ("float32", "uint8"):
        raise ValueError(f"dtype {dtype!r} not in ('float32', 'uint8')")
    b64 = manifest.get("image_b64")
    if not isinstance(b64, str):
        raise ValueError("image_b64 missing")
    try:
        raw = base64.b64decode(b64, validate=True)
    except Exception as e:  # noqa: BLE001 - malformed base64
        raise ValueError(f"image_b64 does not decode: {e}") from None
    want = shape[0] * shape[1] * shape[2] * (4 if dtype == "float32"
                                             else 1)
    if len(raw) != want:
        raise ValueError(
            f"payload is {len(raw)} bytes; shape {shape} x {dtype} "
            f"needs {want}"
        )
    frame = np.frombuffer(raw, np.float32 if dtype == "float32"
                          else np.uint8).reshape(shape)
    if dtype == "uint8":
        frame = frame.astype(np.float32) / 255.0
    else:
        frame = frame.astype(np.float32)
    if shape[2] == 1:
        frame = frame[..., 0]
    return frame

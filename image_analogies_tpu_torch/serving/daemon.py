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
ballast rows are trimmed before demux.  The default grain is the
mesh's rank count (1 without one), as the reference's is its mesh's
device count.

Multi-device (serving/ranks.py, `serve --n-devices N`): with a `mesh`
(a `ServingMesh`, this process being rank 0 of its world) every
sessionless dispatch runs over all ranks, the frames split over the
"batch" axis, the other ranks following rank 0's dispatches through the
mesh's channel; warmup goes through the same channel, one dispatch at a
time.  Session frames stay solo on rank 0.  A world that loses a rank
answers the batch in flight and every later sessionless batch 503 with
Retry-After (their journal entries kept for a takeover), turns /healthz
503 and drains; `serve` then exits nonzero.

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

The fleet's parts (the reference's rounds 18-23, with the router in
serving/router.py):

  - Warm tier (serving/excache.DiskExecCache) under the fleet-shared
    `warm_dir`, else the state dir: the index of shapes the fleet has
    dispatched.  `warmup` dispatches every sealed shape once before the
    announce (`restore_warm_set`, span `disk-restored`, verdict
    `disk`), and an in-memory miss probes the index for the same
    verdict.  The observed-warmup file lives there too, merged by every
    replica.
  - Shape lattice (serving/lattice.py, `lattice=`): sessionless frames
    are edge-padded up to the smallest bucket containing them at
    `_make_request`, before the executable key and the luma bucket are
    computed, and demux crops each answer back to its request's shape;
    warmup dispatches every bucket before the announce.  A frame over
    the top rung bypasses to the exact-key path (an honest miss);
    session traffic never buckets.
  - Session adoption (`adopt_sessions`, `POST /sessions/adopt`): a
    survivor restores a drained replica's sessions from that replica's
    state dir, which the drain snapshot wrote sessions-first.
  - Telemetry archive and black box (telemetry/archive.py,
    `archive_dir=`): periodic snapshots on the sampler tick, a final
    one at drain, anomaly baselines and the observatory generation
    resumed at start, and an incident bundle captured when an SLO
    objective burns fast or a watch fires (`/incidents`, `/archive`).
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import json
import logging
import os
import queue as stdqueue
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .accesslog import AccessLog, find_request
from .fleettrace import parse_hop, valid_token
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
# Requests whose answer's write `GET /request` still reports.
_WRITE_MEMO = 4096

def _request_id_from_headers(headers) -> str:
    """The request's id: the client's `X-Request-Id` when present and
    a well-formed trace token (fleettrace.valid_token: short and safe,
    since it lands in logs, span attrs and metric labels verbatim),
    else a fresh server-generated one."""
    if headers:
        for k, v in headers.items():
            if str(k).lower() == "x-request-id" and valid_token(v):
                return v
    return uuid.uuid4().hex[:12]



def _trace_context_from_headers(headers) -> Dict[str, Any]:
    """Inbound distributed-trace context (round 22): `X-Parent-Span`
    (the upstream hop's span id — the fleet router's, normally) and
    `X-Trace-Hop` (a small decimal: the router sends 1).  Returns {}
    when neither header is present (direct untraced traffic pays
    nothing).  Malformed or oversized values are REPLACED (a new span
    id, hop 1) and echoed back, by the router's own validators
    (fleettrace.valid_token, parse_hop): a hostile value must not
    poison logs/span attrs, and a request must never be rejected over
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
    if parent is None or not valid_token(parent):
        parent = uuid.uuid4().hex[:12]
    hop_n = parse_hop(hop)
    return {"parent_span": parent, "hop": 1 if hop_n is None else hop_n}


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
      restore_ms = the same prologue wall when the verdict was `disk`
                   (a warm-tier shape), booked under its own name so
                   the restore population never blends into the
                   compile one (compile_ms is then 0)
      execute_ms = admitted -> executed (the cache lookup that gives
                   the verdict included), minus compile/restore
      demux_ms   = executed -> the response (demux + settle + handler
                   wakeup — everything after the engine returned)
    Each phase begins at the stamp where the one before it ends, on the
    request's one monotonic clock, so the parts sum to total_ms; with
    `_book_response`'s ingest (arrival -> enqueue) and encode (done ->
    payload) they tile the request's whole wall, which is what lets the
    trace CLI assert its 5%% reconstruction bound and the fleet
    waterfall cover a routed request."""
    t = {ev["name"]: ev["t_ms"] for ev in req.spans}
    out: Dict[str, float] = {}
    admitted = t.get("admitted")
    if admitted is not None:
        out["queue_ms"] = round(admitted, 3)
    verdict = t.get(
        "cache-hit", t.get("disk-restored", t.get("compiled"))
    )
    executed = t.get("executed")
    if None not in (admitted, verdict, executed):
        window = max(0.0, executed - admitted)
        c = min(float(req.compile_ms or 0.0), window)
        if "disk-restored" in t:
            out["compile_ms"] = 0.0
            out["restore_ms"] = round(c, 3)
        else:
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
        warm_dir: Optional[str] = None,
        drain_deadline_s: float = 30.0,
        dispatch_deadline_s: Optional[float] = None,
        pipeline_window: int = 2,
        warmup_workers: int = 4,
        obs_interval_s: float = 5.0,
        obs_capacity: int = 120,
        anomaly_config=None,
        lattice=None,
        archive_dir: Optional[str] = None,
        archive_interval_s: float = 30.0,
        incident_min_interval_s: float = 60.0,
        mesh=None,
    ):
        from ..models.analogy import resolve_device
        from ..telemetry.anomaly import AnomalyDetector
        from ..telemetry.slo import SloEngine
        from ..telemetry.timeseries import TimeSeriesRing

        # A "cuda" daemon without a card refuses here, before binding.
        resolve_device(cfg)
        self.a = np.asarray(a, np.float32)
        self.ap = np.asarray(ap, np.float32)
        self.cfg = cfg
        self.registry = registry
        self.tracer = tracer
        self.flight = flight
        # The serving world (serving/ranks.ServingMesh), or None: one
        # process on one device.
        self.mesh = mesh
        # Why the mesh lost a rank, once it has (the daemon drains).
        self.world_lost: Optional[str] = None
        if max_batch is None:
            max_batch = mesh.size if mesh is not None else 1
        self.policy = BatchingPolicy(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
        )
        self.admission = AdmissionController(
            max_depth=max_queue_depth, registry=registry
        )
        # Shape lattice: a LatticePlan (the CLI's planner output), a
        # LatticeConfig (planned here), or None (off).  Resolved before
        # the cache: its capacity must hold the whole bucket grid plus
        # headroom for bypass keys, or warmup would evict its own work.
        self.lattice = None
        self.lattice_plan = None
        if lattice is not None:
            from .lattice import LatticeConfig, plan_lattice

            if isinstance(lattice, LatticeConfig):
                lattice = plan_lattice(lattice)
            self.lattice_plan = lattice
            self.lattice = lattice.lattice
            cache_capacity = max(cache_capacity, self.lattice.size + 2)
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
        # The warm tier (DiskExecCache, built in start() when a warm
        # root exists).
        self.disk = None
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
        # Fleet-shared warm directory: N replicas root their warm tier
        # and observed-warmup file there (journal, lock and sessions
        # stay per replica in state_dir).  None: the state dir.
        self.warm_dir = warm_dir
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
        # Running mean of per-request pad waste over lattice-admitted
        # (non-bypass) traffic: handler threads book it, so guarded.
        self._lattice_lock = threading.Lock()
        self._lattice_waste_sum = 0.0
        self._lattice_waste_n = 0
        # Runtime-observed frame shapes, LRU order: snapshotted to
        # warmup.observed.json and merged into the successor's warmup.
        # With the lattice on this set holds BUCKET shapes (what a
        # successor must warm); the raw client shapes are tracked
        # separately for the `view="raw"` cardinality cell.
        self._observed_shapes: "OrderedDict[Tuple[int, ...], None]" = \
            OrderedDict()
        self._observed_raw_shapes: \
            "OrderedDict[Tuple[int, ...], None]" = OrderedDict()
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
        # Durable telemetry archive + black box (built in start():
        # reload must precede the first anomaly evaluation).  Interval
        # <= 0 keeps the archive open (boot and drain records,
        # incidents) but skips the periodic snapshots.
        self.archive_dir = archive_dir
        self.archive = None
        self.incidents = None
        self._archive_interval_s = float(archive_interval_s)
        self._incident_min_interval_s = float(incident_min_interval_s)
        self._archive_last_t = -float("inf")
        # Set, under `_archive_lock`, with the final snapshot: no
        # record may follow a boot's final one (`history` reads a
        # boot's `final` from its last snapshot), and a sampler tick
        # already past the drain check still takes the lock.
        self._archive_lock = threading.Lock()
        self._archive_sealed = False
        # request_id -> the answer's write (ms), newest _WRITE_MEMO.
        self._write_ms: "OrderedDict[str, float]" = OrderedDict()
        self._write_lock = threading.Lock()
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
        self._h_write = r.histogram(
            "ia_serve_write_ms",
            "the answer's write to the client socket (ms), after the "
            "access-log line: the tail of the request's wall",
        )
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
        if self.lattice is not None:
            self._c_lattice = r.counter(
                "ia_lattice_admissions_total",
                "sessionless admissions through the shape lattice by "
                "path: bucketed (padded up to a bucket), exact "
                "(already on a bucket shape), bypass (over the top "
                "rung: exact-key path, honest miss)",
            )
            self._g_lattice_waste = r.gauge(
                "ia_lattice_bucket_waste_frac",
                "running mean fraction of the bucket canvas that is "
                "pad, over lattice-admitted requests (the per-request "
                "compute price of bounded exec-key cardinality)",
            )
            self._g_lattice_buckets = r.gauge(
                "ia_lattice_buckets",
                "exec-key cardinality bound the lattice guarantees "
                "for in-bounds sessionless traffic (rungs^2 x "
                "channels)",
            )
            self._g_lattice_waste.set(0.0)
            self._g_lattice_buckets.set(self.lattice.size)

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
        if self._warm_root is not None:
            # The warm tier: the fleet's sealed shapes, restored by
            # `warmup` before the announce.  Under a shared --warm-dir
            # every replica reads the union every replica sealed.
            from .excache import DiskExecCache, backend_fingerprint

            self.disk = DiskExecCache(
                os.path.join(self._warm_root, "excache"),
                backend_fingerprint(self.cfg.device),
                registry=self.registry,
            )
        if self.observability:
            self.access = AccessLog(
                self._access_log_path
                or os.path.join(self._work_dir, "access.jsonl")
            )
        if self.archive_dir is not None:
            # Reload BEFORE the sampler starts: this boot's first
            # anomaly evaluation grades against the pre-restart
            # baseline, and the ring generation starts past every
            # archived window's stamp.
            from ..telemetry.archive import (
                IncidentStore,
                TelemetryArchive,
            )

            self.archive = TelemetryArchive(
                self.archive_dir, registry=self.registry
            )
            self.incidents = IncidentStore(
                self.archive_dir, registry=self.registry,
                min_interval_s=self._incident_min_interval_s,
            )
            resumed = self.archive.resumed
            if (self.obs is not None
                    and resumed.get("generation") is not None):
                self.obs.seed_generation(int(resumed["generation"]) + 1)
            if (self.anomaly is not None
                    and resumed.get("baseline_p99_ms") is not None
                    and self.anomaly.config.baseline_p99_ms is None):
                # No --baseline given: the archived one (what the
                # previous boot graded against) carries over.  An
                # explicit --baseline always wins.
                self.anomaly.config = dataclasses.replace(
                    self.anomaly.config,
                    baseline_p99_ms=float(resumed["baseline_p99_ms"]),
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
                ("POST", "/sessions/adopt"): self._route_sessions_adopt,
                ("GET", "/incidents"): self._route_incidents,
                ("GET", "/archive"): self._route_archive,
            },
        ).start()
        if self.obs is not None:
            # Anomaly evaluation rides the sampler tick (never the
            # request path), so /healthz and the status gauges are at
            # most one interval stale.
            self.obs.start_sampler(on_tick=self._obs_tick)
        if self.mesh is not None:
            self.mesh.on_lost(self._on_world_lost)
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
        if self.archive is not None:
            self.archive.close()
            self.archive = None
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

    @property
    def devices(self) -> int:
        """The ranks a sessionless dispatch runs on."""
        return self.mesh.size if self.mesh is not None else 1

    # -------------------------------------------------------- warmup
    def warmup(self, entries: List[Dict[str, Any]]) -> List[Dict]:
        """Dispatch the manifest's shapes through the real dispatch
        path BEFORE announcing the endpoint (cli.cmd_serve orders it
        so): rendezvous implies warm.  With a warm root (the state dir,
        or the fleet-shared --warm-dir) the warm tier's sealed shapes
        go first, one dispatch each, as its restore (`disk` verdicts,
        `ia_excache_disk_restore_ms`), and the manifest is merged with
        the RUNTIME-OBSERVED shapes of warmup.observed.json, the fix
        for manifest drift (under a shared warm dir, the union every
        replica merged in).  With the lattice on, the whole bucket grid
        joins, and the dedup key and the dispatch both run through the
        bucketing `_make_request` applies.  Distinct shapes warm
        concurrently on `warmup_workers` threads, with per-shape walls
        on the warmup span tree (run_warmup's docstring).  Returns the
        restore's and the warmup's per-shape records."""
        if self._warm_root is not None:
            entries = merge_warmup_entries(
                entries, load_observed_warmup(self.observed_warmup_path),
            )
        if self.lattice is not None:
            entries = merge_warmup_entries(entries, self.lattice.shapes())

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
            return exec_key(
                self._lattice_shape(shape), self.cfg,
                self.policy.max_batch,
            )

        report: List[Dict] = []
        if self.disk is not None:
            restored = set()
            for rec in self.disk.restore_warm_set(dispatch):
                key = key_fn(rec["shape"])
                self.cache.note_compile_ms(key, rec["wall_ms"])
                restored.add(key)
                report.append({"key": key_str(key), "verdict": "disk",
                               "wall_ms": rec["wall_ms"]})
            entries = [
                e for e in entries
                if key_fn((e["height"], e["width"], e["channels"]))
                not in restored
            ]
        return report + run_warmup(
            entries, dispatch, self.cache, key_fn,
            max_workers=self.warmup_workers,
            tracer=self.tracer if self.observability else None,
        )

    # ------------------------------------------------------- serving
    def _lattice_shape(self, shape) -> tuple:
        """A shape tuple as the lattice would admit it: (H, W[, C])
        with the leading two axes rounded up to their bucket, raw when
        the lattice is off or the shape bypasses (over the top rung).
        The warmup dedup key and the dispatch path agree on exactly
        this mapping."""
        if self.lattice is None:
            return tuple(shape)
        b = self.lattice.bucket_for(int(shape[0]), int(shape[1]))
        if b is None:
            return tuple(shape)
        return b + tuple(shape[2:])

    def _make_request(self, frame: np.ndarray,
                      session: Optional[str] = None,
                      req_id: Optional[str] = None) -> ServeRequest:
        # Session dispatches run one frame at a time through the
        # stream, so their cache identity is the batch-1 grain, not
        # the daemon's padding grain.
        grain = 1 if session is not None else self.policy.max_batch
        crop = None
        # Lattice admission, sessionless only: pad BEFORE the executable
        # key and the luma bucket are computed, so the compat identity,
        # the dispatch stack and the warm-tier seal see the bucket shape
        # and nothing else.  (A session's carried state is sized to its
        # true frames.)
        if self.lattice is not None and session is None:
            h, w = int(frame.shape[0]), int(frame.shape[1])
            b = self.lattice.bucket_for(h, w)
            if b is None:
                path = "bypass"
            elif b == (h, w):
                path = "exact"
            else:
                pad = [(0, b[0] - h), (0, b[1] - w)]
                if frame.ndim == 3:
                    pad.append((0, 0))
                frame = np.pad(frame, pad, mode="edge")
                crop = (h, w)
                path = "bucketed"
            # Client and replay traffic only (warmup's synthetic
            # dispatches carry no request id and are not admissions).
            if req_id:
                self._c_lattice.inc(labels={"path": path})
                if b is not None:
                    waste = self.lattice.waste_frac(h, w, b[0], b[1])
                    with self._lattice_lock:
                        self._lattice_waste_sum += waste
                        self._lattice_waste_n += 1
                        self._g_lattice_waste.set(round(
                            self._lattice_waste_sum
                            / self._lattice_waste_n, 6,
                        ))
        key = exec_key(frame.shape, self.cfg, grain)
        bucket = None
        if self.cfg.color_mode == "luminance" and \
                self.cfg.luminance_remap:
            bucket = _luma_bucket(frame)
        kwargs = {"req_id": req_id} if req_id else {}
        return ServeRequest(
            frame=frame, key=key, compat=key + (bucket, session),
            b_stats=bucket, session=session, crop=crop, **kwargs,
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
        # The request's clock starts when its connection was accepted,
        # before the handler's thread started (the live server's
        # stamps; a later request on a kept-alive connection starts at
        # its request line), and `accept_ms` is that wait.  The
        # answer's write is timed after it (`_note_write`).
        ctx = ctx if ctx is not None else {}
        t_recv = ctx.get("t_received") or time.monotonic()
        t_in = ctx.get("t_accepted") or t_recv
        accept_ms = (t_recv - t_in) * 1000.0
        ctx["after_send"] = functools.partial(self._note_write, rid)
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
                rid, req, t_in, bytes_in, tctx, accept_ms
            )
        finally:
            with self._outstanding_lock:
                self._outstanding -= 1

    def _await_response(self, rid: str, req: ServeRequest,
                        t_in: float, bytes_in: int,
                        tctx: Optional[Dict[str, Any]] = None,
                        accept_ms: float = 0.0):
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
            t_done = time.monotonic()
            payload = _json_bytes({
                "status": "failed", "request_id": rid,
                "error": req.error, **tctx,
            })
            self._book_response(
                rid, req, "timeout", 504,
                (time.monotonic() - t_in) * 1000.0, bytes_in,
                len(payload), trace=tctx, t_in=t_in, t_done=t_done,
                accept_ms=accept_ms,
            )
            return 504, payload, "application/json"
        t_done = time.monotonic()
        # The daemon's clock (enqueue -> done): the lifecycle histogram
        # and the answer's `wall_ms`.
        total_ms = (t_done - req.enqueue_t) * 1000.0
        self._h_latency.observe(total_ms, labels={"phase": "total"})

        def book(outcome, code, payload):
            self._book_response(
                rid, req, outcome, code, (time.monotonic() - t_in) * 1000.0,
                bytes_in, len(payload), trace=tctx, t_in=t_in,
                t_done=t_done, accept_ms=accept_ms,
            )

        if req.status == "cancelled":
            # Retired before dispatch (socket gone / deadline blown in
            # queue).  499 after nginx's "client closed request"; the
            # body exists for the rare still-listening client.
            payload = _json_bytes({
                "status": "cancelled", "request_id": rid,
                "error": req.error, **tctx,
            })
            book("cancelled", 499, payload)
            return 499, payload, "application/json"
        if req.status == "unavailable":
            # The serving world lost a rank: the entry stays in the
            # journal for the takeover, and the client may retry there.
            retry = max(1.0, round(self.drain_deadline_s, 1))
            payload = _json_bytes({
                "status": "unavailable", "request_id": rid,
                "error": req.error, "retry_after_s": retry,
                "spans": req.spans, **tctx,
            })
            book("unavailable", 503, payload)
            return (503, payload, "application/json",
                    {"Retry-After": str(int(np.ceil(retry)))})
        if req.status != "ok":
            payload = _json_bytes({
                "status": "failed", "request_id": rid,
                "error": req.error, "spans": req.spans, **tctx,
            })
            book("failed", 500, payload)
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
        book("ok", 200, payload)
        return 200, payload, "application/json"

    def _book_response(self, rid: str, req: Optional[ServeRequest],
                       outcome: str, code: int, total_ms: float,
                       bytes_in: int, bytes_out: int,
                       trace: Optional[Dict[str, Any]] = None,
                       t_in: Optional[float] = None,
                       t_done: Optional[float] = None,
                       accept_ms: float = 0.0) -> None:
        """Response-time bookkeeping, one call per exit path: the
        request-duration observation (always — it is the SLO engine's
        raw material) and the access-log line (observability only).
        `total_ms` runs from the request's arrival (its connection's
        accept) to its payload; an admitted request's line splits it
        into accept (accept -> the handler's thread at the request
        line), ingest (-> enqueue: body, decode, admission, journal),
        the lifecycle phases to `t_done`, and encode (the payload); the
        write that follows is `write_ms` (`_note_write`), which `GET
        /request` adds to the phases and to the total, so they tile the
        wall a router observes around this replica.
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
            if t_in is not None and t_done is not None:
                # The wall anchor moves back to the arrival with the
                # total it anchors.
                entry["t0"] = round(req.t0 - (req.enqueue_t - t_in), 6)
                entry["accept_ms"] = round(accept_ms, 3)
                entry["ingest_ms"] = round(
                    (req.enqueue_t - t_in) * 1000.0 - accept_ms, 3)
                entry.update(_phase_attribution(
                    req, (t_done - req.enqueue_t) * 1000.0))
                entry["encode_ms"] = round(max(
                    0.0, total_ms - (t_done - t_in) * 1000.0), 3)
            else:
                entry.update(_phase_attribution(req, total_ms))
        self.access.log(entry)

    def _note_write(self, rid: str, write_ms: float) -> None:
        """The answer's write (the live server times it after the
        handler returned): `ia_serve_write_ms`, and the request's
        `write_ms` for `GET /request` (the newest `_WRITE_MEMO`)."""
        self._h_write.observe(write_ms)
        with self._write_lock:
            self._write_ms[rid] = round(write_ms, 3)
            while len(self._write_ms) > _WRITE_MEMO:
                self._write_ms.popitem(last=False)

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

    # ------------------------------------ archive + black box
    def _obs_tick(self) -> None:
        """The sampler tick, in order: grade the anomaly watches,
        persist the periodic archive snapshot when the cadence says so,
        then run the black-box trigger check.  Never the request hot
        path, and an archive failure never takes the sampler down (the
        archive counts its own write errors; this guard covers the
        bundle assembly)."""
        report = (self.anomaly.evaluate()
                  if self.anomaly is not None else None)
        if self.archive is None:
            return
        try:
            now = time.monotonic()
            if (self._archive_interval_s > 0
                    and not self._archive_sealed
                    and now - self._archive_last_t
                    >= self._archive_interval_s):
                self._archive_last_t = now
                self._archive_snapshot(anomaly_report=report)
            self._maybe_capture_incident(report)
        except Exception:  # noqa: BLE001 - observer never kills
            _LOG.exception("telemetry archive tick failed")

    def _archive_snapshot(self, anomaly_report=None,
                          final: bool = False) -> bool:
        """One durable snapshot record: the obs window (with its
        generation stamp), the graded SLO report, the anomaly report
        and the ACTIVE latency baseline (what a successor resumes
        against), and the lattice / shape-cardinality state."""
        if self.archive is None:
            return False
        if anomaly_report is None and self.anomaly is not None:
            anomaly_report = self.anomaly.evaluate()
        return self._archive_append("snapshot", {
            "final": bool(final),
            "obs_window": (self.obs.window()
                           if self.obs is not None else None),
            "obs_generation": (self.obs.generation
                               if self.obs is not None else None),
            "slo": self.slo.evaluate(),
            "anomaly": anomaly_report,
            "anomaly_baseline_p99_ms": (
                self.anomaly.config.baseline_p99_ms
                if self.anomaly is not None else None
            ),
            "lattice": self._lattice_snapshot(),
            "shape_cardinality": {
                "raw": len(self._observed_raw_shapes),
                "bucketed": len(self._observed_shapes),
            },
        }, seal=final)

    def _archive_append(self, kind: str, payload: Dict[str, Any],
                        seal: bool = False) -> bool:
        """Append one archive record unless the boot's final
        snapshot is already written; `seal` marks this record as that
        final one.  False when nothing was appended."""
        with self._archive_lock:
            archive = self.archive
            if self._archive_sealed or archive is None:
                return False
            if seal:
                self._archive_sealed = True
            return archive.append(kind, payload)

    def _maybe_capture_incident(self, anomaly_report=None) -> \
            Optional[str]:
        """The black-box trigger: an SLO objective in fast_burn or
        exhausted, or a firing anomaly watch, captures ONE bundle (the
        store rate-limits per trigger kind, so an episode that stays
        hot across many ticks yields one).  Captures are noted in the
        archive stream too, so `history` shows them beside the
        restarts they explain."""
        if self.incidents is None:
            return None
        slo_report = self.slo.evaluate()
        burning = [
            o for o in slo_report.get("objectives", [])
            if o.get("status") in ("fast_burn", "exhausted")
        ]
        firing = list((anomaly_report or {}).get("firing") or [])
        if not burning and not firing:
            return None
        trigger = {
            "kind": "slo_burn" if burning else "anomaly",
            "objectives": [
                {"name": o.get("name"), "status": o.get("status"),
                 "burn_rate": o.get("burn_rate")}
                for o in burning
            ],
            "watches": firing,
        }
        inc_id = self.incidents.capture(
            trigger, self._incident_bundle(slo_report, anomaly_report)
        )
        if inc_id is not None:
            self._archive_append("incident", {
                "id": inc_id, "trigger": trigger,
            })
        return inc_id

    def _incident_bundle(self, slo_report,
                         anomaly_report) -> Dict[str, Any]:
        """A self-contained crime scene: everything `incident <id>`
        and a post-mortem need without the daemon alive."""
        tail: List[Dict[str, Any]] = []
        if self.access is not None:
            from collections import deque

            from .accesslog import read_entries

            # A bounded tail across every rotation generation.
            tail = list(deque(read_entries(self.access.path), maxlen=100))
        return {
            "flight": (self.flight.to_dict(reason="incident")
                       if self.flight is not None else None),
            "access_tail": tail,
            "obs_window": (self.obs.window()
                           if self.obs is not None else None),
            "slo": slo_report,
            "anomaly": anomaly_report,
            "serving": {
                "queue_depth": len(self.queue),
                "inflight": self._inflight,
                "draining": self._draining.is_set(),
                "cache": self.cache.snapshot(),
                "lattice": self._lattice_snapshot(),
            },
            "fingerprint": self._fingerprint(),
        }

    def _fingerprint(self) -> Dict[str, Any]:
        """Config and backend identity for the bundle: enough to answer
        "was the incident daemon running the config I think it was"."""
        return {
            "pid": os.getpid(),
            "boot_id": (self.archive.boot_id
                        if self.archive is not None else None),
            "backend": self.cfg.device,
            "devices": self.devices,
            "config": dataclasses.asdict(self.cfg),
            "policy": {
                "max_batch": self.policy.max_batch,
                "max_wait_ms": self.policy.max_wait_ms,
                "max_queue_depth": self.admission.max_depth,
                "pipeline_window": self.pipeline_window,
            },
            "state_dir": self.state_dir,
            "archive_dir": self.archive_dir,
        }

    def _route_incidents(self, _body, _headers, ctx):
        """GET /incidents: the black-box index; `?id=` returns one full
        bundle.  404 (not an empty list) when the archive is off, so
        the router's fan-out can tell the feature's absence from the
        absence of incidents."""
        from ..telemetry.archive import list_incidents, load_incident

        if self.incidents is None:
            return 404, _json_bytes({
                "error": "incident capture disabled "
                         "(no --archive-dir)",
            }), "application/json"
        inc_id = (ctx.get("query") or {}).get("id") if ctx else None
        if inc_id:
            doc = load_incident(self.archive_dir, inc_id)
            if doc is None:
                return 404, _json_bytes({
                    "error": f"incident {inc_id!r} not found",
                    "id": inc_id,
                }), "application/json"
            return 200, _json_bytes(doc), "application/json"
        return 200, _json_bytes({
            "archive_dir": self.archive_dir,
            "incidents": list_incidents(self.archive_dir),
            **self.incidents.stats(),
        }), "application/json"

    def _route_archive(self, _body):
        """GET /archive: live archive stats and what reload resumed."""
        if self.archive is None:
            return 404, _json_bytes({
                "error": "telemetry archive disabled "
                         "(no --archive-dir)",
            }), "application/json"
        snap = self.archive.stats()
        snap["incidents"] = (self.incidents.stats()
                             if self.incidents is not None else None)
        snap["anomaly_baseline_p99_ms"] = (
            self.anomaly.config.baseline_p99_ms
            if self.anomaly is not None else None
        )
        snap["obs_generation"] = (self.obs.generation
                                  if self.obs is not None else None)
        return 200, _json_bytes(snap), "application/json"

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
        with self._write_lock:
            write_ms = self._write_ms.get(rid)
        if entry is not None and write_ms is not None:
            # The write follows the logged total; it joins the clock
            # here, so the phases, write included, tile the total.
            entry = {**entry, "write_ms": write_ms,
                     "total_ms": round(entry["total_ms"] + write_ms, 3)}
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
        in-flight occupancy, cache residency, the warm tier and the
        lattice, and the SLO quantiles.  The router's poller routes on
        queue_depth + inflight and reads the drain state and state_dir
        (the migration source) from here."""
        snap = {
            "devices": self.devices,
            "backend": self.cfg.device,
            "ranks": (self.mesh.snapshot()
                      if self.mesh is not None else None),
            "queue_depth": len(self.queue),
            "inflight": self._inflight,
            "backlog": self._backlog,
            "draining": self._draining.is_set(),
            "state_dir": self.state_dir,
            "warm_dir": self.warm_dir,
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
            "disk_cache": (self.disk.snapshot()
                           if self.disk is not None else None),
            "lattice": self._lattice_snapshot(),
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

    def _lattice_snapshot(self) -> Optional[Dict[str, Any]]:
        """The /serving lattice section: grid geometry, the decision's
        provenance, and the live waste / cardinality numbers (None with
        the lattice off)."""
        if self.lattice is None:
            return None
        with self._lattice_lock:
            waste_n = self._lattice_waste_n
            mean_waste = (self._lattice_waste_sum / waste_n
                          if waste_n else 0.0)
        snap = dict(self.lattice.snapshot())
        snap.update({
            "source": (self.lattice_plan.source
                       if self.lattice_plan is not None
                       else "direct"),
            "plan": (self.lattice_plan.as_dict()
                     if self.lattice_plan is not None else None),
            "mean_bucket_waste_frac": round(mean_waste, 6),
            "admissions": waste_n,
            "shape_cardinality": {
                "raw": len(self._observed_raw_shapes),
                "bucketed": len(self._observed_shapes),
            },
        })
        return snap

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
        if self.archive is not None:
            # The final archive record BEFORE the flight flush: the
            # successor's reload reads baselines and the generation
            # from the freshest window.
            try:
                self._archive_snapshot(final=True)
            except Exception:  # noqa: BLE001 - drain must terminate
                _LOG.exception("final archive snapshot failed")
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
        journal's pending-only compaction.  Sessions first: the router
        is told "drained" only after this whole function, but a kill
        can land inside it, and the compaction is the one destructive
        step, so a kill leaves either the old journal intact or the
        full snapshot plus a compacted journal, never a compacted
        journal without the session snapshot a survivor adopts."""
        if self.state_dir is None:
            if self.warm_dir is not None:
                self._save_observed_shapes()
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
    def _warm_root(self) -> Optional[str]:
        """Directory the warm tier and the observed warmup live under:
        the fleet-shared --warm-dir when set, else the state dir."""
        return self.warm_dir if self.warm_dir is not None \
            else self.state_dir

    @property
    def observed_warmup_path(self) -> Optional[str]:
        root = self._warm_root
        if root is None:
            return None
        return os.path.join(root, OBSERVED_WARMUP_FILE)

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
        author guessed.  With the lattice on, the PERSISTED set holds
        bucket shapes (persisting the raw long tail would fragment a
        successor's warmup into the cardinality the lattice bounds)
        while the raw client shapes feed the `view="raw"` cell; with
        no lattice the two cells are one series.  The unlabeled cell
        follows the bucketed series, the one the anomaly watch
        grades."""
        shape = manifest.get("shape")
        if not (isinstance(shape, list) and len(shape) == 3):
            return
        raw = tuple(int(d) for d in shape)
        key = raw
        if self.lattice is not None:
            self._lru_note(self._observed_raw_shapes, raw)
            b = self.lattice.bucket_for(raw[0], raw[1])
            if b is not None:
                key = b + raw[2:]
        fresh = self._lru_note(self._observed_shapes, key)
        bucketed = len(self._observed_shapes)
        raw_card = (len(self._observed_raw_shapes)
                    if self.lattice is not None else bucketed)
        self._g_shape_card.set(bucketed)
        self._g_shape_card.set(raw_card, labels={"view": "raw"})
        self._g_shape_card.set(bucketed, labels={"view": "bucketed"})
        if fresh and self._warm_root is not None:
            try:
                self._save_observed_shapes()
            except OSError:
                pass

    def _save_observed_shapes(self) -> None:
        if self._warm_root is None or not self._observed_shapes:
            return
        # Under a fleet-shared warm dir each replica UNIONS its shapes
        # into the file (overwriting would shrink the fleet's observed
        # set to the last drainer's slice).
        save_observed_warmup(
            self.observed_warmup_path, list(self._observed_shapes),
            merge=self.warm_dir is not None,
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

    def adopt_sessions(self, source_state_dir: str,
                       only: Optional[List[str]] = None) -> List[str]:
        """Cross-replica session migration: restore session streams
        from ANOTHER replica's drain snapshot (the router calls POST
        /sessions/adopt when it drains a replica, handing its pinned
        sessions to a survivor over the shared filesystem).  `only`
        limits adoption to the named ids; None adopts the whole
        snapshot.  Best-effort per session: one that fails to restore
        runs its next frame cold wherever it lands.  Returns the
        adopted ids.

        Runs on an HTTP handler thread while the dispatcher owns
        `_sessions`: dict insertion is safe under the GIL, and the
        router routes an adopted session's next frame here only after
        this call returns, so the dispatcher never races the restore
        of a stream it is using."""
        from ..telemetry.spans import span_at
        from ..video.sequence import VideoStream

        p_adopt0 = time.perf_counter()
        idx_path = os.path.join(source_state_dir, "sessions.json")
        try:
            with open(idx_path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return []
        sessions = doc.get("sessions")
        if not isinstance(sessions, dict):
            return []
        wanted = None if only is None else {str(s) for s in only}
        cfg = dataclasses.replace(self.cfg, save_level_artifacts=None)
        adopted: List[str] = []
        restores = []  # (sid, restored, p_start, p_end) for the span
        for sid, dirname in sessions.items():
            if not (isinstance(sid, str) and isinstance(dirname, str)):
                continue
            if wanted is not None and sid not in wanted:
                continue
            sdir = os.path.join(source_state_dir, "sessions",
                                os.path.basename(dirname))
            p_s0 = time.perf_counter()
            stream = VideoStream(
                self.a, self.ap, cfg=cfg, registry=self.registry
            )
            restored = stream.restore_state(sdir)
            restores.append((sid, restored, p_s0, time.perf_counter()))
            if restored:
                self._sessions[sid] = stream
                self._sessions.move_to_end(sid)
                adopted.append(sid)
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
        p_adopt1 = time.perf_counter()
        if adopted:
            self.registry.counter(
                "ia_serve_sessions_adopted_total",
                "session streams adopted from another replica's drain "
                "snapshot (fleet migration)",
            ).inc(len(adopted))
        self.registry.histogram(
            "ia_serve_adopt_ms",
            "wall of one /sessions/adopt restore (the replica half of "
            "a drain migration)",
        ).observe((p_adopt1 - p_adopt0) * 1000.0)
        if self.tracer is not None and self.tracer.enabled:
            # The adopt as a span tree (one session_restore child per
            # stream), so a repinned session's first frame can point at
            # the restore cost.
            root = span_at(
                "sessions_adopt", p_adopt0, p_adopt1,
                source=source_state_dir, sessions=len(adopted),
            )
            for sid, restored, a, b in restores:
                root.children.append(span_at(
                    "session_restore", a, b, session=sid,
                    restored=restored,
                ))
            self.tracer.attach_tree(root)
        return adopted

    def _route_sessions_adopt(self, body: Optional[bytes]):
        """POST /sessions/adopt {"state_dir": DIR, "sessions": [...]}:
        the router-facing migration endpoint (adopt_sessions above).
        Refused while draining: a draining replica sheds sessions, it
        does not collect them."""
        try:
            doc = json.loads((body or b"{}").decode("utf-8"))
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            src = doc.get("state_dir")
            if not isinstance(src, str) or not src:
                raise ValueError("state_dir (source replica's state "
                                 "dir) is required")
            only = doc.get("sessions")
            if only is not None and not (
                isinstance(only, list)
                and all(isinstance(s, str) for s in only)
            ):
                raise ValueError("sessions must be a list of strings")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, _json_bytes(
                {"status": "rejected", "error": str(e)}
            ), "application/json"
        if self._draining.is_set():
            return 503, _json_bytes({
                "status": "unavailable",
                "error": "daemon is draining; adopt elsewhere",
            }), "application/json"
        adopted = self.adopt_sessions(src, only=only)
        return 200, _json_bytes({
            "status": "ok",
            "adopted": adopted,
            "sessions_active": len(self._sessions),
        }), "application/json"

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

        health = evaluate_health(
            metrics=self.registry.to_dict(), context="serving"
        )
        if self.world_lost is not None:
            health["checks"].append({
                "name": "serving_ranks", "status": "violated",
                "provenance": "measured", "expected": self.devices,
                "observed": None,
                "detail": f"serving world lost: {self.world_lost}; "
                          "draining for a takeover",
            })
            health["counts"]["violated"] += 1
            health["verdict"] = "violated"
        return health

    def _on_world_lost(self, reason: str) -> None:
        """The mesh lost a rank (serving/ranks.py): /healthz turns 503
        and the daemon drains; `serve` exits nonzero after."""
        self.world_lost = reason
        self.registry.counter(
            "ia_serve_world_lost_total",
            "serving worlds that lost a rank (the daemon drains)",
        ).inc()
        self.begin_drain(reason="rank-lost")

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
        sentinel's `hits + misses == dispatches` contract).  With a
        warm tier every in-memory MISS is resolved one level further
        down: `probe` books exactly one of disk-hit / disk-miss (the
        sentinel's `disk hits + disk misses == misses`), and a sealed
        key upgrades the verdict to `disk` (span `disk-restored`).
        Returns the admission timestamp."""
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
        if cache_status == "miss" and self.disk is not None:
            cache_status = self.disk.probe(batch[0].key, kind=kind)
        span_name = {
            "hit": "cache-hit", "disk": "disk-restored",
        }.get(cache_status, "compiled")
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
        from .ranks import WorldLost

        if batch[0].session is not None:
            self._execute_session(batch, kind=kind)
            return

        grain = self.policy.max_batch
        admit_t = self._admit_batch(batch, kind)
        ckpt_dir = None
        run_tracer = None
        out = None
        ok = False
        gaveup = lost = None

        def settle():
            try:
                if ok:
                    demux(batch, out[: len(batch)])
                    for req in batch:
                        if kind == "client":
                            self._c_completed.inc()
                elif lost is not None:
                    for req in batch:
                        req.status = "unavailable"
                        req.error = f"serving world lost a rank: {lost}"
                        req.journal_keep = True
                        if kind == "client":
                            self._c_failed.inc()
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
                if self.mesh is not None:
                    return self.mesh.run(
                        frames, cfg, resume_from=resume_from,
                        b_stats=b_stats, progress=run_tracer,
                    )
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
            except WorldLost as e:
                lost = e
            if ok and self.disk is not None:
                # Sealed only after a successful dispatch: a failed one
                # never claims a warm shape.
                fs = batch[0].frame.shape
                self.disk.seal(batch[0].key,
                               fs if len(fs) == 3 else fs + (1,))
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

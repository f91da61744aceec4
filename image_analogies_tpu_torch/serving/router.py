"""Fleet router — the routing half of fleet-scale serving: the
reference's module, copied.  It imports no torch and touches no
tensor, so a `python -m image_analogies_tpu_torch.cli route` process
never initialises CUDA; `ia-synth` below is the reference's CLI name.
Round 21 (the reference; the observation half is
serving/observatory.py).

One `SynthDaemon` replica is one process with one queue; the router is
the lightweight front tier that makes N of them behave like one
service: `POST /synthesize` spreads across replicas by least
outstanding work (the router's own in-flight count per replica PLUS
the queue_depth + inflight each replica reports on `/serving`, scraped
by a background poller), while a request carrying `session_id` sticks
to the replica holding that session's warm-start stream — spreading a
video session across replicas would re-pay a cold frame per hop, so
affinity is correctness-adjacent, not a nicety.

The router holds NO synthesis state and imports NO JAX: it is cheap
enough to run in-process next to anything (the CLI's `ia-synth route`,
the load harness, a test).  All durable state lives in the replicas:

  - requests are journaled AT THE REPLICA after admission, so a proxy
    retry after a CONNECTION failure is safe (the request either never
    reached admission, or it is journaled and a takeover will replay
    it — outputs are bit-identical either way, by the round-16
    isolation contract);
  - sessions migrate THROUGH THE FILESYSTEM: `drain_replica` drains
    the victim (its drain snapshot writes sessions BEFORE the journal
    compaction — the round-21 ordering fix), then tells a survivor to
    `POST /sessions/adopt` from the victim's state dir, then re-pins
    the affinity table.  The router only ever coordinates; it never
    carries NNF state over HTTP.

Telemetry flows through the standard registry (`ia_route_*` families,
kept by the observatory's scrape filter) and the router answers
`/metrics.json` + `/slo` like any replica, so `ia-synth obs` pointed
at the discovery file grades router and replicas in one sweep.  The
discovery file (`--discovery-out`) is rewritten atomically on every
membership/drain change: `{"targets": [...]}` is exactly what
`ia-synth obs --targets <file>` consumes (round 21 satellite).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

ROUTER_SCHEMA_VERSION = 1
DISCOVERY_KIND = "fleet_discovery"

# Outcome vocabulary for ia_route_duration_ms — aligned with the
# replica's ia_request_duration_ms outcomes so telemetry/slo.py's
# admitted/bad split applies unchanged: `unavailable`/`shed`/
# `cancelled`/`rejected` are availability-EXCLUDED (round-16
# semantics: the backend never owed those requests a response), while
# `failed`/`timeout` burn budget and `ok` earns it.
_OUTCOME_BY_CODE = {
    200: "ok", 400: "rejected", 429: "shed", 499: "cancelled",
    503: "unavailable", 504: "timeout",
}


def _outcome_for_code(code: int) -> str:
    return _OUTCOME_BY_CODE.get(code, "failed")


def _header(headers, name: str) -> Optional[str]:
    """Case-insensitive header lookup over whatever mapping the HTTP
    layer handed us."""
    want = name.lower()
    for k, v in (headers or {}).items():
        if str(k).lower() == want and isinstance(v, str):
            return v
    return None

# One proxy hop is bounded by the replica's own behavior (admission
# sheds, dispatch deadlines); the router just needs to outlast a cold
# compile on the slowest replica.
DEFAULT_PROXY_TIMEOUT_S = 600.0


class ReplicaHandle:
    """Router-side view of one replica: identity + the poller's last
    scrape + the router's own outstanding-proxy count."""

    def __init__(self, name: str, url: str,
                 state_dir: Optional[str] = None):
        self.name = name
        self.url = url.rstrip("/")
        self.state_dir = state_dir
        self.alive = False
        self.draining = False
        self.queue_depth = 0
        self.inflight = 0
        self.outstanding = 0  # router-local proxies in flight
        self.poll_ms: Optional[float] = None
        self.proxied = 0
        self.errors = 0

    def score(self) -> int:
        """Least-outstanding-requests with queue-depth awareness: the
        router's own unreturned proxies (instant) plus the replica's
        last-reported backlog (poll-interval stale; the local count
        covers the staleness window)."""
        return self.outstanding + self.queue_depth + self.inflight

    def snapshot(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "url": self.url,
            "state_dir": self.state_dir,
            "alive": self.alive,
            "draining": self.draining,
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "outstanding": self.outstanding,
            "poll_ms": self.poll_ms,
            "proxied": self.proxied,
            "errors": self.errors,
        }


def _http_json(url: str, timeout: float, *, method: str = "GET",
               body: Optional[bytes] = None) -> Any:
    req = urllib.request.Request(
        url, data=body, method=method,
        headers={"Content-Type": "application/json"} if body else {},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _session_from_body(body: Optional[bytes]) -> Optional[str]:
    """The request's session_id, parsed leniently: routing must never
    reject what the replica would accept — a malformed body routes
    anywhere and gets the replica's own 400."""
    if not body:
        return None
    try:
        manifest = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    sid = manifest.get("session_id") if isinstance(manifest, dict) \
        else None
    return sid if isinstance(sid, str) and sid else None


class FleetRouter:
    """The front tier.  `start()` binds the HTTP endpoint (a
    LiveTelemetryServer, same surface as every daemon) and the poller;
    `add_replica` / `remove_replica` / `drain_replica` manage
    membership.  Thread-safety: membership + affinity live behind one
    lock; proxying happens OUTSIDE it (only the pick and the
    bookkeeping lock)."""

    def __init__(self, registry, *, tracer=None, host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 0.5,
                 scrape_timeout_s: float = 5.0,
                 proxy_timeout_s: float = DEFAULT_PROXY_TIMEOUT_S,
                 discovery_path: Optional[str] = None,
                 flight=None, access_log_path: Optional[str] = None):
        from ..telemetry.spans import as_tracer

        self.registry = registry
        self.tracer = as_tracer(tracer)
        self.host = host
        self._requested_port = port
        self.poll_interval_s = float(poll_interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.discovery_path = discovery_path
        self.flight = flight
        self.live = None
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._affinity: Dict[str, str] = {}  # session_id -> replica
        self._seq = 0
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        # Plain counters mirrored into the registry: /fleet reads them
        # without walking serialized metric families.
        self.affinity_counts = {"hit": 0, "new": 0, "repin": 0}
        self.proxied = 0
        self.proxy_errors = 0
        self.retries = 0
        self.migrations = 0
        r = registry
        self._c_requests = r.counter(
            "ia_route_requests_total",
            "requests proxied through the fleet router, by replica "
            "and outcome",
        )
        self._c_affinity = r.counter(
            "ia_route_affinity_total",
            "session-affinity routing decisions (hit: pinned replica "
            "served; new: first sighting pinned; repin: pin moved off "
            "a draining/dead replica)",
        )
        self._c_migrations = r.counter(
            "ia_route_migrations_total",
            "session streams migrated between replicas at drain",
        )
        self._g_outstanding = r.gauge(
            "ia_route_outstanding",
            "router-local in-flight proxies per replica",
        )
        self._g_up = r.gauge(
            "ia_route_replica_up",
            "replica reachability from the router's poller (1 up, "
            "0 down)",
        )
        self._g_draining = r.gauge(
            "ia_route_replica_draining",
            "replica drain state as the router sees it (1 draining)",
        )
        self._h_proxy = r.histogram(
            "ia_route_proxy_ms",
            "router proxy wall per request (pick + replica round "
            "trip), by outcome",
        )
        from ..telemetry.slo import (
            REQUEST_DURATION_BUCKETS,
            ROUTE_DURATION_METRIC,
        )

        # Router-observed end-to-end latency — same bucket ladder and
        # outcome vocabulary as the replica family, so the existing
        # SloEngine grades the router hop with unchanged budget
        # arithmetic (round-22 satellite: router requests no longer
        # vanish from SLO math).
        self._h_duration = r.histogram(
            ROUTE_DURATION_METRIC,
            "router-observed request latency (ms) by outcome/replica "
            "— the raw family the router SLO objectives grade",
            buckets=REQUEST_DURATION_BUCKETS,
        )
        self._c_retries = r.counter(
            "ia_route_retries_total",
            "proxy attempts re-routed to another replica, by reason "
            "(conn_error: connection-level failure; draining: replica "
            "refused before admission)",
        )
        self._c_unrouted = r.counter(
            "ia_route_unrouted_total",
            "requests the router could not place on any live "
            "non-draining replica (503 + Retry-After)",
        )
        self._h_migration = r.histogram(
            "ia_route_migration_ms",
            "drain-time session migration wall (drain signal -> "
            "sessions adopted + re-pinned) per drain_replica call",
        )
        # Router-side JSONL access log (round-22 tentpole): same
        # durability contract as the replica's (serving/accesslog.py),
        # one line per routed request with per-phase walls and the
        # chosen replica.  Off (None) unless a path is given — the
        # hot path stays allocation-free when untraced.
        from .accesslog import AccessLog

        self.access = (
            AccessLog(access_log_path) if access_log_path else None
        )
        self._slo_engine = None

    # ------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        from ..telemetry.live import LiveTelemetryServer

        self.live = LiveTelemetryServer(
            self.tracer,
            self.registry,
            port=self._requested_port,
            host=self.host,
            flight=self.flight,
            health_cb=self.health,
            routes={
                ("POST", "/synthesize"): self._route_synthesize,
                ("GET", "/fleet"): self._route_fleet,
                ("GET", "/replicas"): self._route_replicas,
                ("GET", "/slo"): self._route_slo,
                ("GET", "/request"): self._route_request,
                ("GET", "/incidents"): self._route_incidents,
                ("POST", "/replicas/add"): self._route_add,
                ("POST", "/replicas/remove"): self._route_remove,
                ("POST", "/drain_replica"): self._route_drain_replica,
            },
        ).start()
        self._poller = threading.Thread(
            target=self._poll_loop, name="ia-route-poll", daemon=True
        )
        self._poller.start()
        self._write_discovery()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=10.0)
            self._poller = None
        if self.live is not None:
            self.live.stop()
            self.live = None
        if self.access is not None:
            self.access.close()

    @property
    def url(self) -> str:
        return self.live.url

    def health(self) -> Dict[str, Any]:
        with self._lock:
            live = sum(1 for h in self._replicas.values() if h.alive)
            total = len(self._replicas)
        return {
            "verdict": "ok" if live else "violated",
            "context": "router",
            "replicas_live": live,
            "replicas_total": total,
        }

    # ----------------------------------------------------- membership
    def add_replica(self, url: str, name: Optional[str] = None,
                    state_dir: Optional[str] = None) -> ReplicaHandle:
        """Register one replica.  Its state_dir (the migration source/
        sink) comes from the caller or from the replica's own /serving
        snapshot on the first successful poll."""
        url = url.rstrip("/")
        with self._lock:
            for h in self._replicas.values():
                if h.url == url:
                    return h
            if name is None:
                name = f"r{self._seq}"
                self._seq += 1
            if name in self._replicas:
                raise ValueError(f"replica name {name!r} already "
                                 "registered")
            handle = ReplicaHandle(name, url, state_dir)
            self._replicas[name] = handle
        self._poll_one(handle)
        self._write_discovery()
        return handle

    def remove_replica(self, name: str) -> bool:
        with self._lock:
            handle = self._replicas.pop(name, None)
            if handle is None:
                return False
            for sid in [s for s, rep in self._affinity.items()
                        if rep == name]:
                del self._affinity[sid]
        self._write_discovery()
        return True

    def replicas(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [h.snapshot() for h in self._replicas.values()]

    # -------------------------------------------------------- polling
    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            with self._lock:
                handles = list(self._replicas.values())
            for h in handles:
                self._poll_one(h)

    def _poll_one(self, h: ReplicaHandle) -> None:
        t0 = time.monotonic()
        try:
            snap = _http_json(h.url + "/serving",
                              self.scrape_timeout_s)
            h.queue_depth = int(snap.get("queue_depth") or 0)
            h.inflight = int(snap.get("inflight") or 0)
            h.draining = bool(snap.get("draining"))
            if h.state_dir is None:
                sd = snap.get("state_dir")
                if isinstance(sd, str) and sd:
                    h.state_dir = sd
            h.alive = True
            h.poll_ms = round((time.monotonic() - t0) * 1000.0, 2)
        except (urllib.error.URLError, OSError, ValueError):
            h.alive = False
        self._g_up.set(1.0 if h.alive else 0.0,
                       labels={"replica": h.name})
        self._g_draining.set(1.0 if h.draining else 0.0,
                             labels={"replica": h.name})

    # -------------------------------------------------------- routing
    def _pick(self, session: Optional[str],
              exclude: Optional[str] = None):
        """One routing decision under the lock: affinity first (a live
        non-draining pinned replica is a `hit`), else least score.
        Returns (handle, affinity_result|None, considered) where
        `considered` lists every candidate's outstanding score at
        decision time (the `pick` span's attrs — round-22 trace
        fabric); books the outstanding increment the caller must pair
        with `_settle`."""
        with self._lock:
            result = None
            handle = None
            considered: List[Dict[str, Any]] = []
            if session is not None:
                pinned = self._affinity.get(session)
                if pinned is not None:
                    h = self._replicas.get(pinned)
                    if (h is not None and h.alive and not h.draining
                            and h.name != exclude):
                        handle, result = h, "hit"
                        considered = [{"replica": h.name,
                                       "score": h.score(),
                                       "pinned": True}]
            if handle is None:
                candidates = [
                    h for h in self._replicas.values()
                    if h.alive and not h.draining and h.name != exclude
                ]
                considered = [{"replica": h.name, "score": h.score()}
                              for h in candidates]
                if not candidates:
                    return None, None, considered
                handle = min(
                    candidates, key=lambda h: (h.score(), h.name)
                )
                if session is not None:
                    result = ("repin" if session in self._affinity
                              else "new")
                    self._affinity[session] = handle.name
            if result is not None:
                self.affinity_counts[result] += 1
                self._c_affinity.inc(labels={"result": result})
            handle.outstanding += 1
            self._g_outstanding.set(
                float(handle.outstanding),
                labels={"replica": handle.name},
            )
            return handle, result, considered

    def _settle(self, handle: ReplicaHandle, ok: bool) -> None:
        with self._lock:
            handle.outstanding = max(0, handle.outstanding - 1)
            self._g_outstanding.set(
                float(handle.outstanding),
                labels={"replica": handle.name},
            )
            if ok:
                handle.proxied += 1
                self.proxied += 1
            else:
                handle.errors += 1
                self.proxy_errors += 1

    def _route_synthesize(self, body: Optional[bytes], headers=None):
        """Proxy one /synthesize.  Connection-level failures mark the
        replica down and retry ONCE elsewhere (safe: admission
        journals before ack, and replayed outputs are bit-identical);
        HTTP-level replies (200/400/429/503) pass through — except a
        draining 503, which re-routes once because the poller simply
        hasn't caught the drain yet.

        Round-22 trace fabric: every request gets a validated (or
        generated — malformed values replaced, never rejected, the
        round-15 id policy) `X-Request-Id`, the router's own span id is
        forwarded downstream as `X-Parent-Span` with an incremented
        `X-Trace-Hop`, and — when the router is traced — the whole hop
        is reconstructed as a `route_request` span tree (received ->
        pick -> proxy_attempt per try -> respond) plus one access-log
        line with per-phase walls and the chosen replica, joinable
        with the replica's `serve_request` tree by request id."""
        from ..telemetry.spans import new_span_id, span_at
        from .fleettrace import parse_hop, valid_token

        p_recv = time.perf_counter()
        t0_wall = time.time()
        session = _session_from_body(body)
        raw_rid = _header(headers, "x-request-id")
        rid = (raw_rid if raw_rid is not None and valid_token(raw_rid)
               else new_span_id())
        raw_parent = _header(headers, "x-parent-span")
        client_parent = (
            raw_parent
            if raw_parent is None or valid_token(raw_parent)
            else new_span_id()
        )
        hop_in = parse_hop(_header(headers, "x-trace-hop"))
        hop_out = (hop_in if hop_in is not None else 0) + 1
        span_id = new_span_id()
        traced = self.tracer.enabled or self.access is not None
        bytes_in = len(body or b"")
        children: List[Tuple[str, float, float, Dict[str, Any]]] = []
        attempts: List[Dict[str, Any]] = []
        retries = 0
        pick_ms = 0.0
        proxy_ms = 0.0
        p_received_end = time.perf_counter()
        if traced:
            children.append(("received", p_recv, p_received_end, {}))

        def finish(code, payload, ctype, extra_headers, outcome,
                   replica, proxy_outcome):
            p_end = time.perf_counter()
            total_ms = (p_end - p_recv) * 1000.0
            self._h_proxy.observe(total_ms,
                                  labels={"outcome": proxy_outcome})
            self._h_duration.observe(total_ms, labels={
                "outcome": outcome, "replica": replica or "none",
            }, exemplar=rid)
            out_headers = {
                "X-Request-Id": rid,
                "X-Parent-Span": span_id,
                "X-Trace-Hop": str(hop_out),
            }
            out_headers.update(extra_headers or {})
            if traced:
                p_last = children[-1][2] if children else p_recv
                children.append(("respond", p_last, p_end, {}))
                root_attrs: Dict[str, Any] = {
                    "request_id": rid, "span_id": span_id,
                    "outcome": outcome, "http_status": code,
                    "replica": replica, "attempts": len(attempts),
                    "retries": retries, "hop": hop_in or 0,
                }
                if session is not None:
                    root_attrs["session"] = session
                if client_parent is not None:
                    root_attrs["parent_span"] = client_parent
                root = span_at("route_request", p_recv, p_end,
                               **root_attrs)
                for name, a, b, attrs in children:
                    root.children.append(
                        span_at(name, a, b, request_id=rid, **attrs)
                    )
                self.tracer.attach_tree(root)
                if self.access is not None:
                    entry: Dict[str, Any] = {
                        "ts": root.ts, "t0": round(t0_wall, 6),
                        "kind": "router", "route": "/synthesize",
                        "request_id": rid, "span_id": span_id,
                        "hop": hop_in or 0,
                        "session_id": session, "outcome": outcome,
                        "http_status": code, "replica": replica,
                        "attempts": attempts, "retries": retries,
                        "total_ms": round(total_ms, 3),
                        "pick_ms": round(pick_ms, 3),
                        "proxy_ms": round(proxy_ms, 3),
                        "respond_ms": round(
                            (p_end - p_last) * 1000.0, 3),
                        "bytes_in": bytes_in,
                        "bytes_out": len(payload or b""),
                    }
                    if client_parent is not None:
                        entry["parent_span"] = client_parent
                    self.access.log(entry)
            return (code, payload, ctype, out_headers)

        exclude = None
        for attempt in (0, 1):
            p_pick0 = time.perf_counter()
            handle, aff, considered = self._pick(session,
                                                 exclude=exclude)
            p_pick1 = time.perf_counter()
            pick_ms += (p_pick1 - p_pick0) * 1000.0
            if traced:
                pick_attrs: Dict[str, Any] = {
                    "replica": handle.name if handle else None,
                    "considered": considered,
                }
                if aff is not None:
                    pick_attrs["affinity"] = aff
                children.append(("pick", p_pick0, p_pick1, pick_attrs))
            if handle is None:
                self._c_unrouted.inc()
                payload = json.dumps({
                    "status": "unavailable",
                    "error": "no live non-draining replica",
                    "request_id": rid,
                }).encode()
                return finish(503, payload, "application/json",
                              {"Retry-After": "1"}, "unavailable",
                              None, "unrouted")
            hdrs = {
                "Content-Type": "application/json",
                "X-Request-Id": rid,
                "X-Parent-Span": span_id,
                "X-Trace-Hop": str(hop_out),
            }
            req = urllib.request.Request(
                handle.url + "/synthesize", data=body or b"{}",
                method="POST", headers=hdrs,
            )
            code = None
            p_send = time.perf_counter()
            try:
                with urllib.request.urlopen(
                    req, timeout=self.proxy_timeout_s
                ) as resp:
                    code, payload = resp.status, resp.read()
                    resp_headers = dict(resp.headers)
            except urllib.error.HTTPError as e:
                code, payload = e.code, e.read()
                resp_headers = dict(e.headers)
            except (urllib.error.URLError, OSError):
                # Connection refused/reset: the replica is gone (or
                # going).  Mark it down so the next pick skips it and
                # retry the request elsewhere once.
                p_fail = time.perf_counter()
                wall = (p_fail - p_send) * 1000.0
                proxy_ms += wall
                self._settle(handle, ok=False)
                with self._lock:
                    handle.alive = False
                self._g_up.set(0.0, labels={"replica": handle.name})
                self._c_requests.inc(labels={
                    "replica": handle.name, "outcome": "conn_error",
                })
                retrying = attempt == 0
                attempts.append({
                    "replica": handle.name, "outcome": "conn_error",
                    "wall_ms": round(wall, 3),
                    "retry_reason": "conn_error" if retrying else None,
                })
                if traced:
                    children.append(("proxy_attempt", p_send, p_fail, {
                        "replica": handle.name, "outcome": "conn_error",
                        "retry_reason": (
                            "conn_error" if retrying else None),
                    }))
                if retrying:
                    with self._lock:
                        self.retries += 1
                    retries += 1
                    self._c_retries.inc(
                        labels={"reason": "conn_error"})
                    exclude = handle.name
                    continue
                payload = json.dumps({
                    "status": "unavailable",
                    "error": "replica connection failed twice",
                    "request_id": rid,
                }).encode()
                return finish(502, payload, "application/json", {},
                              "failed", handle.name, "conn_error")
            p_resp = time.perf_counter()
            wall = (p_resp - p_send) * 1000.0
            proxy_ms += wall
            draining_503 = False
            if code == 503 and attempt == 0:
                try:
                    draining_503 = json.loads(
                        payload.decode("utf-8")
                    ).get("status") == "unavailable"
                except (ValueError, UnicodeDecodeError):
                    draining_503 = False
            if draining_503:
                # The replica started draining between polls: it
                # refused BEFORE admission (no journal entry), so a
                # re-route duplicates nothing.
                self._settle(handle, ok=False)
                with self._lock:
                    handle.draining = True
                    self.retries += 1
                retries += 1
                self._c_retries.inc(labels={"reason": "draining"})
                self._g_draining.set(
                    1.0, labels={"replica": handle.name}
                )
                self._c_requests.inc(labels={
                    "replica": handle.name, "outcome": "draining",
                })
                attempts.append({
                    "replica": handle.name, "outcome": "draining",
                    "wall_ms": round(wall, 3),
                    "retry_reason": "draining",
                })
                if traced:
                    children.append(("proxy_attempt", p_send, p_resp, {
                        "replica": handle.name, "outcome": "draining",
                        "retry_reason": "draining",
                    }))
                exclude = handle.name
                continue
            self._settle(handle, ok=code == 200)
            self._c_requests.inc(labels={
                "replica": handle.name, "outcome": str(code),
            })
            attempts.append({
                "replica": handle.name, "outcome": str(code),
                "wall_ms": round(wall, 3),
            })
            if traced:
                children.append(("proxy_attempt", p_send, p_resp, {
                    "replica": handle.name, "outcome": str(code),
                }))
            out_headers = {"X-Routed-To": handle.name}
            if "Retry-After" in resp_headers:
                out_headers["Retry-After"] = resp_headers["Retry-After"]
            return finish(code, payload, "application/json",
                          out_headers, _outcome_for_code(code),
                          handle.name,
                          "ok" if code == 200 else "error")
        raise AssertionError("unreachable")

    # ------------------------------------------------- drain/migrate
    def drain_replica(self, name: str, wait_s: float = 120.0
                      ) -> Dict[str, Any]:
        """Rolling-restart primitive: stop routing to `name`, POST its
        /drain, wait for `drained` (the drain snapshot — sessions
        BEFORE journal compaction — is on disk once that flips), then
        hand its pinned sessions to the least-loaded survivor via
        /sessions/adopt and re-pin them.  Synchronous; returns the
        migration report.  The caller owns the process afterwards
        (kill, takeover, re-add).

        Round-22 migration visibility: the whole drain is one
        `drain_migration` span tree (drain_wait -> sessions_adopt ->
        repin) attached to the router tracer, and the drain-to-adopted
        wall lands in `ia_route_migration_ms` — so a repinned
        session's first frame shows its true cost attribution in the
        fleet waterfall instead of an anonymous stall."""
        from ..telemetry.spans import span_at

        p_drain0 = time.perf_counter()
        mig_children: List[Any] = []
        with self._lock:
            handle = self._replicas.get(name)
            if handle is None:
                raise KeyError(f"unknown replica {name!r}")
            handle.draining = True
            pinned = [s for s, rep in self._affinity.items()
                      if rep == name]
        self._g_draining.set(1.0, labels={"replica": name})
        self._write_discovery()
        report: Dict[str, Any] = {
            "replica": name, "state_dir": handle.state_dir,
            "sessions_pinned": list(pinned), "drained": False,
            "sessions_migrated": [], "migrated_to": None,
        }
        try:
            _http_json(handle.url + "/drain", self.scrape_timeout_s,
                       method="POST", body=b"{}")
        except (urllib.error.URLError, OSError, ValueError):
            # Already dead: its sessions still migrate below if a
            # snapshot exists on disk (e.g. a previous drain).
            pass
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                snap = _http_json(handle.url + "/journal",
                                  self.scrape_timeout_s)
                if snap.get("drained"):
                    report["drained"] = True
                    break
            except (urllib.error.URLError, OSError, ValueError):
                # Process exited after drain: snapshot is on disk.
                report["drained"] = True
                break
            time.sleep(0.1)
        p_wait1 = time.perf_counter()
        if self.tracer.enabled:
            mig_children.append(span_at(
                "drain_wait", p_drain0, p_wait1, replica=name,
                drained=report["drained"],
            ))
        if pinned and handle.state_dir:
            with self._lock:
                candidates = [
                    h for h in self._replicas.values()
                    if h.alive and not h.draining and h.name != name
                ]
                target = min(
                    candidates, key=lambda h: (h.score(), h.name)
                ) if candidates else None
            if target is not None:
                p_adopt0 = time.perf_counter()
                try:
                    resp = _http_json(
                        target.url + "/sessions/adopt",
                        self.proxy_timeout_s, method="POST",
                        body=json.dumps({
                            "state_dir": handle.state_dir,
                            "sessions": pinned,
                        }).encode(),
                    )
                    adopted = resp.get("adopted") or []
                    p_adopt1 = time.perf_counter()
                    if self.tracer.enabled:
                        mig_children.append(span_at(
                            "sessions_adopt", p_adopt0, p_adopt1,
                            source=name, target=target.name,
                            sessions=len(adopted),
                        ))
                    with self._lock:
                        for sid in adopted:
                            self._affinity[sid] = target.name
                        self.migrations += len(adopted)
                    if adopted:
                        self._c_migrations.inc(len(adopted))
                    if self.tracer.enabled:
                        mig_children.append(span_at(
                            "repin", p_adopt1, time.perf_counter(),
                            target=target.name,
                            sessions=len(adopted),
                        ))
                    report["sessions_migrated"] = adopted
                    report["migrated_to"] = target.name
                except (urllib.error.URLError, OSError, ValueError) as e:
                    report["migrate_error"] = f"{type(e).__name__}: {e}"
                    if self.tracer.enabled:
                        mig_children.append(span_at(
                            "sessions_adopt", p_adopt0,
                            time.perf_counter(), source=name,
                            target=target.name, error=str(e),
                        ))
        p_done = time.perf_counter()
        migration_ms = round((p_done - p_drain0) * 1000.0, 3)
        report["migration_ms"] = migration_ms
        self._h_migration.observe(migration_ms)
        if self.tracer.enabled:
            root = span_at(
                "drain_migration", p_drain0, p_done, replica=name,
                drained=report["drained"],
                migrated_to=report["migrated_to"],
                sessions=len(report["sessions_migrated"]),
            )
            root.children.extend(mig_children)
            self.tracer.attach_tree(root)
        self._write_discovery()
        return report

    # ------------------------------------------------------ discovery
    def discovery(self) -> Dict[str, Any]:
        """The replica-discovery doc `ia-synth obs --targets FILE`
        consumes: `targets` lists every live scrape surface (replicas
        + the router itself — ia_route_* families ride the same
        registry protocol)."""
        with self._lock:
            reps = [h.snapshot() for h in self._replicas.values()]
        return {
            "schema_version": ROUTER_SCHEMA_VERSION,
            "kind": DISCOVERY_KIND,
            "router": self.live.url if self.live is not None else None,
            "replicas": reps,
            "targets": (
                [r["url"] for r in reps]
                + ([self.live.url] if self.live is not None else [])
            ),
        }

    def _write_discovery(self) -> None:
        if not self.discovery_path:
            return
        from ..utils.io import atomic_write_json

        try:
            atomic_write_json(self.discovery_path, self.discovery())
        except OSError:
            pass

    # --------------------------------------------------------- routes
    def _route_fleet(self, _body):
        with self._lock:
            snap = {
                "router": self.live.url if self.live else None,
                "replicas": [h.snapshot()
                             for h in self._replicas.values()],
                "affinity": {
                    "sessions": len(self._affinity),
                    **self.affinity_counts,
                },
                "requests": {
                    "proxied": self.proxied,
                    "errors": self.proxy_errors,
                    "retries": self.retries,
                },
                "migrations_total": self.migrations,
            }
        return 200, _json_bytes(snap), "application/json"

    def _route_replicas(self, _body):
        return 200, _json_bytes(self.discovery()), "application/json"

    def _route_slo(self, _body):
        """Router-grade /slo: the standard objective evaluation over
        the router's OWN duration family (`ia_route_duration_ms`,
        graded by the same SloEngine the replicas use — round-22
        satellite) plus the fleet anomaly watches, so the observatory
        scrapes the router exactly like a replica."""
        from ..telemetry.anomaly import fleet_watches
        from ..telemetry.slo import ROUTE_DURATION_METRIC, SloEngine

        if self._slo_engine is None:
            self._slo_engine = SloEngine(
                self.registry, metric=ROUTE_DURATION_METRIC
            )
        report = self._slo_engine.evaluate()
        report["anomalies"] = fleet_watches(
            self.replicas(), self.registry
        )
        return 200, _json_bytes(report), "application/json"

    def _route_request(self, _body, _headers, ctx):
        """GET /request?id=<rid>: the router half of one request's
        fleet trace — its access-log record plus the route_request
        span-tree events still in the flight ring.  Mirrors the
        replica's endpoint so `ia-synth trace <id> --fleet` walks both
        with one code path."""
        from ..telemetry.flight import tree_events
        from .accesslog import find_request

        rid = (ctx.get("query") or {}).get("id") if ctx else None
        if not rid:
            return 400, _json_bytes(
                {"status": "rejected", "error": "id query param "
                 "required"}
            ), "application/json"
        entry = (find_request(self.access.path, rid)
                 if self.access is not None else None)
        events = (tree_events(self.flight.to_dict(), rid)
                  if self.flight is not None else [])
        if entry is None and not events:
            return 404, _json_bytes(
                {"status": "unknown", "request_id": rid}
            ), "application/json"
        return 200, _json_bytes({
            "request_id": rid,
            "kind": "router",
            "request": entry,
            "flight_events": events,
        }), "application/json"

    def _route_incidents(self, _body, _headers, ctx):
        """GET /incidents: the fleet's black-box index — fan out to
        every replica's /incidents (round 23, telemetry/archive.py)
        and merge, tagged by replica.  `?id=` proxies one full bundle
        from whichever replica has it.  A replica with the archive
        plane off (404) or unreachable mid-fan-out is stated per
        replica, never silently dropped — same honesty rule as the
        observatory's degraded-fleet scrape."""
        inc_id = (ctx.get("query") or {}).get("id") if ctx else None
        with self._lock:
            handles = list(self._replicas.values())
        if inc_id:
            import urllib.parse as _parse

            q = _parse.quote(inc_id, safe="")
            errors = []
            for h in handles:
                try:
                    doc = _http_json(
                        f"{h.url}/incidents?id={q}", 10.0
                    )
                except (urllib.error.URLError, OSError, ValueError) \
                        as e:
                    errors.append(
                        f"{h.name}: {type(e).__name__}: {e}"
                    )
                    continue
                doc["replica"] = h.name
                return 200, _json_bytes(doc), "application/json"
            return 404, _json_bytes({
                "error": f"incident {inc_id!r} unknown to every "
                         "replica",
                "id": inc_id,
                "errors": errors,
            }), "application/json"
        merged = []
        for h in handles:
            rec: Dict[str, Any] = {
                "replica": h.name, "url": h.url, "error": None,
                "incidents": [],
            }
            try:
                doc = _http_json(f"{h.url}/incidents", 10.0)
                rec["incidents"] = doc.get("incidents") or []
                rec["captured"] = doc.get("captured")
                rec["suppressed"] = doc.get("suppressed")
            except (urllib.error.URLError, OSError, ValueError) as e:
                rec["error"] = f"{type(e).__name__}: {e}"
            merged.append(rec)
        return 200, _json_bytes({
            "replicas": merged,
            "incidents_total": sum(
                len(r["incidents"]) for r in merged
            ),
        }), "application/json"

    def _route_add(self, body):
        try:
            doc = json.loads((body or b"{}").decode("utf-8"))
            url = doc.get("url")
            if not isinstance(url, str) or not url:
                raise ValueError("url is required")
            handle = self.add_replica(
                url, name=doc.get("name"),
                state_dir=doc.get("state_dir"),
            )
        except (ValueError, UnicodeDecodeError) as e:
            return 400, _json_bytes(
                {"status": "rejected", "error": str(e)}
            ), "application/json"
        return 200, _json_bytes(
            {"status": "ok", "replica": handle.snapshot()}
        ), "application/json"

    def _route_remove(self, body):
        try:
            doc = json.loads((body or b"{}").decode("utf-8"))
            name = doc.get("name")
            if not isinstance(name, str) or not name:
                raise ValueError("name is required")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, _json_bytes(
                {"status": "rejected", "error": str(e)}
            ), "application/json"
        removed = self.remove_replica(name)
        return 200 if removed else 404, _json_bytes(
            {"status": "ok" if removed else "unknown", "name": name}
        ), "application/json"

    def _route_drain_replica(self, body):
        try:
            doc = json.loads((body or b"{}").decode("utf-8"))
            name = doc.get("name")
            if not isinstance(name, str) or not name:
                raise ValueError("name is required")
            wait_s = float(doc.get("wait_s", 120.0))
        except (ValueError, UnicodeDecodeError) as e:
            return 400, _json_bytes(
                {"status": "rejected", "error": str(e)}
            ), "application/json"
        try:
            report = self.drain_replica(name, wait_s=wait_s)
        except KeyError as e:
            return 404, _json_bytes(
                {"status": "unknown", "error": str(e)}
            ), "application/json"
        return 200, _json_bytes(
            {"status": "ok", **report}
        ), "application/json"


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def load_discovery(path: str) -> Dict[str, Any]:
    """Read a router discovery file; raises ValueError on wrong kind
    (the obs CLI surfaces it as a usage error)."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or doc.get("kind") != DISCOVERY_KIND:
        raise ValueError(
            f"{path}: not a fleet discovery file (kind="
            f"{doc.get('kind') if isinstance(doc, dict) else None!r})"
        )
    return doc

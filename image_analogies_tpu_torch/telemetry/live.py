"""In-process live telemetry endpoint: scrape a run while it runs.

The port's copy of the reference's exporter: an opt-in stdlib
`http.server` on a daemon thread, bound to loopback, serving the same
objects the end-of-run artifacts serialize (no second bookkeeping path
that could drift from them).  The session starts it for `--metrics-port`
(utils/profiling.telemetry_session); the serving daemon mounts its
routes on it (`routes`, `health_cb`).

Endpoints:

  /metrics   the session registry's Prometheus text exposition
             (format 0.0.4, now including the derived `_quantile`
             families and comment-style histogram exemplars) — point
             any scraper at it mid-run.
  /metrics.json  the registry's JSON exposition (registry.to_dict()),
             the form the serving observatory's aggregator merges.
  /healthz   the run sentinel's registry-joinable checks evaluated
             incrementally against the LIVE registry (candidate-DMA /
             polish-DMA / coarse ledgers, energy gauge, overhead,
             recovery; the kernel wrappers book each ledger pair as one
             unit the exposition waits on, so a scrape never splits
             one).  The span-tree completeness check is an
             end-of-run invariant by definition (the run span is
             legitimately open mid-run), so the live verdict evaluates
             with spans=None and that check reports skipped.  HTTP 503
             on a violated verdict (ready-check semantics), and a
             violated live verdict flushes the flight recorder.
  /progress  the open span stack (where the run is right now) plus
             completed-level walls and an ETA — measured walls
             calibrate the per-level cost model the run declared at
             its prologue (models/analogy.record_prologue's `run_plan`
             mark: `level_eta_cost_units`), so the estimate is
             model-shaped but measurement-scaled, and says so
             (`eta_basis`).

Thread-safety posture: the run thread owns the tracer/registry and the
server only READS.  Registry reads take the registry's unit lock and the
per-metric locks; span-tree
reads ride CPython's GIL atomicity for list/dict ops, and the rare
torn read (an attrs dict resized mid-serialize) surfaces as HTTP 500 —
the scraper retries; the RUN is never touched.  Handlers never raise
into the server loop.
"""

from __future__ import annotations

import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

LIVE_FILE = "live.json"


def _split_path(raw: str):
    """(normalized path, {query key: last value}) from a request
    target.  Route matching stays on the bare path — the query reaches
    arity-3 handlers through ctx['query'] instead of widening every
    historical route signature."""
    from urllib.parse import parse_qsl, urlsplit

    parts = urlsplit(raw)
    path = parts.path.rstrip("/") or "/"
    query = dict(parse_qsl(parts.query, keep_blank_values=True))
    return path, query


def _handler_arity(handler) -> int:
    """Positional-parameter count of a route handler, resolved once at
    route registration: 1 -> `handler(body)` (historical), 2 ->
    `handler(body, headers)` (round 15: X-Request-Id), 3+ ->
    `handler(body, headers, ctx)` (round 16: `ctx` carries a
    connection-liveness probe so the serving daemon can cancel queued
    requests whose client already hung up)."""
    try:
        params = [
            p for p in
            inspect.signature(handler).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        return len(params)
    except (TypeError, ValueError):
        return 1


def _wants_headers(handler) -> bool:
    """True when a route handler declares a second positional
    parameter (beyond `body`) — kept as the round-15 name for the
    arity-2 question; `_handler_arity` is the full resolution."""
    return _handler_arity(handler) >= 2


def _socket_alive(sock) -> bool:
    """Non-destructive client-liveness probe: peek one byte without
    blocking.  b'' is the peer's FIN (client hung up); EAGAIN means
    the connection is idle-but-open; any other socket error counts as
    dead.  Never consumes request bytes (MSG_PEEK)."""
    import socket as _socket

    try:
        data = sock.recv(1, _socket.MSG_PEEK | _socket.MSG_DONTWAIT)
    except (BlockingIOError, InterruptedError):
        return True
    except OSError:
        return False
    return data != b""


def _walk_spans(spans):
    for sp in spans or []:
        yield sp
        yield from _walk_spans(sp.get("children", []))


def progress_snapshot(tracer) -> Dict[str, Any]:
    """The /progress payload: open span stack, completed levels, ETA.

    ETA: the `run_plan` mark (recorded by models/analogy.record_prologue
    on instrumented runs) carries per-level modeled cost units; the
    measured walls of completed levels calibrate seconds-per-unit, and
    the remaining levels' units price out at that rate.  With no plan
    (a pre-round-10 caller) the 4x-pixels-per-finer-level pyramid law
    is applied to the finest completed wall instead; with no completed
    level yet the ETA is null — stated, never imputed."""
    tree = tracer.to_dict()
    plan = None
    done: Dict[int, float] = {}
    for sp in _walk_spans(tree.get("spans")):
        if sp.get("name") == "run_plan":
            plan = sp.get("attrs") or {}
        elif sp.get("name") == "level":
            attrs = sp.get("attrs") or {}
            if attrs.get("level") is not None and sp.get("wall_ms"):
                done[int(attrs["level"])] = sp["wall_ms"]

    eta_s = None
    eta_basis = None
    levels_total = plan.get("levels") if plan else None
    remaining = None
    if done:
        if plan and plan.get("eta_cost_units"):
            units = {
                int(lvl): u
                for lvl, u in plan["eta_cost_units"].items()
            }
            done_units = sum(units.get(lvl, 0.0) for lvl in done)
            rem = {
                lvl: u for lvl, u in units.items() if lvl not in done
            }
            remaining = sorted(rem, reverse=True)
            if done_units > 0:
                rate = sum(done.values()) / 1000.0 / done_units
                eta_s = round(rate * sum(rem.values()), 3)
                eta_basis = "cost-model x measured rate"
        else:
            # Pyramid fallback: each finer level has 4x the pixels of
            # the one above it; scale the finest completed wall.
            finest = min(done)
            remaining = list(range(finest - 1, -1, -1))
            eta_s = round(
                done[finest] / 1000.0
                * sum(4.0 ** (finest - lvl) for lvl in remaining),
                3,
            )
            eta_basis = "4x-pyramid law x finest measured level"

    return {
        "stack": tracer.stack_snapshot(),
        "levels_total": levels_total,
        "levels_done": sorted(done, reverse=True),
        "level_wall_ms": {str(lvl): done[lvl] for lvl in sorted(done)},
        "levels_remaining": remaining,
        "eta_s": eta_s,
        "eta_basis": eta_basis,
    }


class _Handler(BaseHTTPRequestHandler):
    # The server thread must never write request logs over the run's
    # stdout/progress stream.
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch_route(self, method: str, path: str,
                        body: Optional[bytes],
                        query: Optional[Dict[str, str]] = None) -> bool:
        """Injected-route dispatch (round 13: the serving daemon mounts
        its endpoints on this same server).  A route handler returns
        (code, body_bytes, ctype[, headers]); True = handled.
        Handlers declaring a second positional parameter additionally
        receive the request headers as a dict (round 15); arity-3
        handlers get a ctx dict whose `query` entry carries the parsed
        query string, last value wins per key (round 19 — /obs/window
        and /request are parameterized GETs)."""
        live = self.server.live  # type: ignore[attr-defined]
        handler = live.routes.get((method, path))
        if handler is None:
            return False
        arity = live._route_arity.get((method, path), 1)
        if arity >= 3:
            conn = self.connection
            ctx = {
                "alive": lambda: _socket_alive(conn),
                "client": self.client_address,
                "query": dict(query or {}),
            }
            out = handler(body, dict(self.headers.items()), ctx)
        elif arity >= 2:
            out = handler(body, dict(self.headers.items()))
        else:
            out = handler(body)
        code, payload, ctype = out[0], out[1], out[2]
        headers = out[3] if len(out) > 3 else None
        self._send(code, payload, ctype, headers)
        return True

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        live = self.server.live  # type: ignore[attr-defined]
        try:
            path, query = _split_path(self.path)
            if self._dispatch_route("GET", path, None, query):
                pass
            elif path == "/metrics":
                self._send(
                    200,
                    live.registry.to_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/metrics.json":
                # The registry's JSON exposition — what the round-19
                # observatory aggregator merges (same shape as the
                # end-of-run metrics.json artifact), so fleet merge
                # arithmetic never round-trips through text parsing.
                body = json.dumps(
                    live.registry.to_dict(), indent=1
                ) + "\n"
                self._send(200, body.encode(), "application/json")
            elif path == "/healthz":
                health = live.evaluate_live_health()
                code = 503 if health["verdict"] == "violated" else 200
                self._send(
                    code,
                    (json.dumps(health, indent=1) + "\n").encode(),
                    "application/json",
                )
            elif path == "/progress":
                body = json.dumps(
                    progress_snapshot(live.tracer), indent=1
                ) + "\n"
                self._send(200, body.encode(), "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the server
            try:
                self._send(
                    500, f"live telemetry error: {e}\n".encode(),
                    "text/plain",
                )
            except Exception:  # noqa: BLE001 - client went away
                pass

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        try:
            path, query = _split_path(self.path)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            if not self._dispatch_route("POST", path, body, query):
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the server
            try:
                self._send(
                    500, f"live telemetry error: {e}\n".encode(),
                    "text/plain",
                )
            except Exception:  # noqa: BLE001 - client went away
                pass


class _Server(ThreadingHTTPServer):
    # The listen backlog: the socketserver default of 5 drops the SYNs
    # of a burst of simultaneous clients past it (the serving daemon's
    # overload arrivals), which then reconnect a second later.
    request_queue_size = 128


class LiveTelemetryServer:
    """The exporter: bind, serve on a daemon thread, announce, stop.

    `port=0` binds an ephemeral port (the bound port is `self.port`
    after `start()`); `announce(dir)` writes `<dir>/live.json` with the
    URL so out-of-process consumers (and the scrape test) can find an
    ephemeral endpoint without parsing stdout."""

    def __init__(self, tracer, registry, port: int = 0,
                 host: str = "127.0.0.1", flight=None,
                 health_cb=None, routes=None):
        """`health_cb` / `routes` (round 13): the serving daemon reuses
        this server rather than growing a second HTTP stack.
        `health_cb() -> health dict` replaces the default sentinel
        evaluation for /healthz (the 503-on-violated and
        flush-on-violated behaviors still apply to whatever it
        returns); `routes` maps (method, path) -> handler(body) ->
        (code, body_bytes, ctype[, headers]) and takes precedence over
        the built-in endpoints.  Both default to the per-run behavior
        every existing caller gets."""
        self.tracer = tracer
        self.registry = registry
        self.flight = flight
        self.host = host
        self._health_cb = health_cb
        self.routes = dict(routes or {})
        self._route_arity = {
            key: _handler_arity(h) for key, h in self.routes.items()
        }
        self._route_headers = {
            key: arity >= 2 for key, arity in self._route_arity.items()
        }
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def evaluate_live_health(self) -> Dict[str, Any]:
        """The sentinel's registry-joinable checks against the live
        registry (module docstring: span-tree completeness is
        end-of-run-only, so spans stay out of the live verdict) — or
        the injected health_cb's verdict."""
        if self._health_cb is not None:
            health = self._health_cb()
        else:
            from .sentinel import evaluate_health

            health = evaluate_health(
                metrics=self.registry.to_dict(), context="live"
            )
        if self.flight is not None and health["verdict"] == "violated":
            self.flight.flush("violation")
        return health

    def start(self) -> "LiveTelemetryServer":
        self._httpd = _Server((self.host, self._requested_port), _Handler)
        self._httpd.live = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        httpd = self._httpd
        self._thread = threading.Thread(
            # Tight poll interval: shutdown() blocks a full poll cycle,
            # and the exporter stops inside the run's teardown path.
            target=lambda: httpd.serve_forever(poll_interval=0.1),
            name="ia-live-telemetry",
            daemon=True,
        )
        self._thread.start()
        import logging

        logging.getLogger("image_analogies_tpu_torch").info(
            "live telemetry: http://%s:%d "
            "(/metrics /metrics.json /healthz /progress)",
            self.host, self.port,
        )
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def announce(self, artifact_dir: str) -> None:
        import os

        from ..utils.io import atomic_write_json

        os.makedirs(artifact_dir, exist_ok=True)
        atomic_write_json(
            os.path.join(artifact_dir, LIVE_FILE),
            {
                "url": self.url,
                "host": self.host,
                "port": self.port,
                "pid": os.getpid(),
                "endpoints": ["/metrics", "/metrics.json", "/healthz",
                              "/progress"]
                + sorted({p for _m, p in self.routes}),
            },
        )

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

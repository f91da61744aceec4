"""The fleet trace of the port (`serving/fleettrace.py`, the router's
trace fabric, the daemon's inbound trace context) against the JAX
package's, on the CPU:

  - the reference's unit classes (tests/test_fleet_trace.py: the token
    grammar, the daemon's trace context and its echo on every exit, the
    router's headers and `/request`, clock-skew honesty, the router-path
    watches, the route SLO), run against the port's modules (the
    functions a reference test imports inside its body are the port's
    too);
  - parity: `join_fleet_trace` and `render_fleet_waterfall` equal to the
    JAX package's on the same records, synthetic and real;
  - end to end: a traced port router over two port daemons; a routed
    request fetched over the discovery file and joined (both processes'
    rows), and a draining replica's 503 re-routed, its retry a named
    `proxy_attempt` row that reconciles with `ia_route_retries_total`.

Frames are 16^2-24^2, two levels, one EM step; torch runs on one
intra-op thread."""

import copy
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import test_fleet_trace as ref  # noqa: E402
from check_fleet_trace import _validate_joined  # noqa: E402
from image_analogies_tpu.serving import fleettrace as j_ft  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving import fleettrace as t_ft  # noqa: E402
from image_analogies_tpu_torch.serving.accesslog import (  # noqa: E402
    read_entries,
)
from image_analogies_tpu_torch.serving.daemon import SynthDaemon  # noqa: E402
from image_analogies_tpu_torch.serving.observatory import (  # noqa: E402
    fleet_route_slo,
)
from image_analogies_tpu_torch.serving.router import (  # noqa: E402
    FleetRouter,
    load_discovery,
)
from image_analogies_tpu_torch.telemetry import flight as t_flight  # noqa: E402
from image_analogies_tpu_torch.telemetry import spans as t_spans  # noqa: E402
from image_analogies_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    set_registry,
)
from test_torch_serving import _SERVE_CFG, _body, _post  # noqa: E402
from torch_ref_swap import swap  # noqa: E402


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    swap(monkeypatch, ref)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_locals(monkeypatch):
    """What reference tests import inside their bodies, as the port's."""
    import image_analogies_tpu.serving.observatory as j_obs
    import image_analogies_tpu.telemetry.flight as j_flight
    import image_analogies_tpu.telemetry.spans as j_spans

    monkeypatch.setattr(j_flight, "FlightRecorder", t_flight.FlightRecorder)
    monkeypatch.setattr(j_spans, "Tracer", t_spans.Tracer)
    monkeypatch.setattr(j_obs, "fleet_route_slo", fleet_route_slo)


def test_reference_names_are_the_ports():
    assert ref.join_fleet_trace is t_ft.join_fleet_trace
    assert ref.FleetRouter is FleetRouter


# ------------------------------------- the reference's unit classes
class TestTraceTokenGrammar(ref.TestTraceTokenGrammar):
    pass


class TestDaemonTraceContext(ref.TestDaemonTraceContext):
    pass


class TestRouterTraceHeaders(ref.TestRouterTraceHeaders):
    def test_request_endpoint_serves_router_half(self, tmp_path,
                                                 monkeypatch):
        _port_locals(monkeypatch)
        super().test_request_endpoint_serves_router_half(tmp_path)


@pytest.fixture(scope="module")
def trace_daemon(tmp_path_factory):
    """The reference's never-dispatching daemon, on the port."""
    rng = np.random.default_rng(3)
    a, ap = (rng.random((16, 16, 3)).astype(np.float32) for _ in range(2))
    reg = MetricsRegistry()
    prev = set_registry(reg)
    daemon = SynthDaemon(
        a, ap, SynthConfig(device="cpu", **_SERVE_CFG), registry=reg,
        max_batch=1, max_wait_ms=5.0, max_queue_depth=2, obs_interval_s=0,
        access_log_path=str(
            tmp_path_factory.mktemp("trace-daemon") / "access.jsonl"),
    ).start()
    try:
        yield daemon
    finally:
        daemon.stop()
        set_registry(prev)


class TestDaemonExitEcho(ref.TestDaemonExitEcho):
    pass


class TestClockSkewHonesty(ref.TestClockSkewHonesty):
    pass


class TestRouterPathWatches(ref.TestRouterPathWatches):
    pass


class TestRouteSlo(ref.TestRouteSlo):
    def test_fleet_route_slo_none_without_router_traffic(self,
                                                          monkeypatch):
        _port_locals(monkeypatch)
        super().test_fleet_route_slo_none_without_router_traffic()


# ---------------------------------------------------------- parity
_CASES = [
    (ref._router_rec(), [ref._replica_rec()]),
    (ref._router_rec(), [ref._replica_rec(t0=1000.5)]),
    (ref._router_rec(), [ref._replica_rec(t0=999.9)]),
    (ref._router_rec(retries=1, attempts=[
        {"replica": "r1", "outcome": "draining", "wall_ms": 6.0,
         "retry_reason": "draining"},
        {"replica": "r0", "outcome": "200", "wall_ms": 84.0}]),
     [ref._replica_rec(total_ms=80.0)]),
    (ref._router_rec(), [ref._replica_rec(compile_ms=0.0,
                                          restore_ms=65.0)]),
    (ref._router_rec(), [ref._replica_rec(total_ms=120.0,
                                          execute_ms=47.0)]),
    (ref._router_rec(), []),
    (None, [ref._replica_rec()]),
]


@pytest.mark.parametrize("router_rec,replica_recs", _CASES)
def test_join_and_waterfall_equal_jax(router_rec, replica_recs):
    t = t_ft.join_fleet_trace(copy.deepcopy(router_rec),
                              copy.deepcopy(replica_recs), "rid-1")
    j = j_ft.join_fleet_trace(copy.deepcopy(router_rec),
                              copy.deepcopy(replica_recs), "rid-1")
    assert t == j
    assert t_ft.render_fleet_waterfall(t) == \
        j_ft.render_fleet_waterfall(j)


# ------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """A traced port router (flight ring, access log, discovery file,
    poller parked) over two port daemons with flight recorders; one
    routed request, then replica r1 drained at the daemon (the router
    still believes it live) while a request pinned to it arrives."""
    work = tmp_path_factory.mktemp("routed")
    rng = np.random.default_rng(5)
    a, ap, b = (rng.random((24, 24, 3)).astype(np.float32)
                for _ in range(3))
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    daemons = []
    for i in range(2):
        reg = MetricsRegistry()
        tr = t_spans.Tracer(registry=reg)
        fl = t_flight.FlightRecorder(tr, reg, str(work / f"f{i}.json"),
                                     capacity=512)
        tr.add_observer(fl.observe)
        daemons.append(SynthDaemon(
            a, ap, cfg, registry=reg, tracer=tr, flight=fl, max_batch=1,
            max_wait_ms=5.0, obs_interval_s=0, drain_deadline_s=30.0,
            access_log_path=str(work / f"access{i}.jsonl")).start())
    reg = MetricsRegistry()
    tracer = t_spans.Tracer(registry=reg)
    flight = t_flight.FlightRecorder(tracer, reg, str(work / "rf.json"),
                                     capacity=1024)
    tracer.add_observer(flight.observe)
    disco = str(work / "fleet.json")
    router = FleetRouter(reg, tracer=tracer, poll_interval_s=60.0,
                         flight=flight, discovery_path=disco,
                         access_log_path=str(work / "raccess.jsonl")
                         ).start()
    out = {}
    try:
        for d in daemons:
            router.add_replica(d.url)
        out["main"] = _post(router.url, _body(b),
                            headers={"X-Request-Id": "main-1"})
        discovery = load_discovery(disco)
        fetched = t_ft.fetch_fleet_trace(discovery, "main-1")
        reps = [r["doc"]["request"] for r in fetched["replicas"]
                if (r.get("doc") or {}).get("request")]
        out["main_joined"] = t_ft.join_fleet_trace(
            fetched["router"]["request"], reps, "main-1")
        with router._lock:
            router._affinity["pinned"] = "r1"
        urllib.request.urlopen(urllib.request.Request(
            daemons[1].url + "/drain", data=b"{}", method="POST"),
            timeout=30).read()
        out["retry"] = _post(router.url, _body(b, session_id="pinned"),
                             headers={"X-Request-Id": "retry-1"})
        fetched = t_ft.fetch_fleet_trace(discovery, "retry-1")
        reps = [r["doc"]["request"] for r in fetched["replicas"]
                if (r.get("doc") or {}).get("request")]
        out["retry_joined"] = t_ft.join_fleet_trace(
            fetched["router"]["request"], reps, "retry-1")
        out["counter"] = sum(reg.to_dict()["ia_route_retries_total"][
            "values"].values())
        out["span_retries"] = sum(
            1 for e in read_entries(router.access.path)
            for att in e.get("attempts") or [] if att.get("retry_reason"))
    finally:
        router.stop()
        for d in daemons:
            d.stop()
    return out


def test_routed_request_joins_both_processes(routed):
    code, doc, hdrs = routed["main"]
    assert code == 200 and doc["request_id"] == "main-1"
    assert doc["parent_span"] == hdrs["X-Parent-Span"]
    joined = routed["main_joined"]
    errs = []
    # The coverage gate (0.95) is the card's: a 24^2 request's HTTP
    # framing is a real share of its wall, reported as gap.
    _validate_joined(joined, "main", errs, require_coverage=False)
    assert errs == []
    assert {r["process"] for r in joined["rows"]} == {
        "router", hdrs["X-Routed-To"]}
    assert 0.0 < joined["critical_path_coverage"] <= 1.0
    text = t_ft.render_fleet_waterfall(joined)
    assert "main-1" in text and hdrs["X-Routed-To"] in text


def test_draining_retry_is_named_and_reconciles(routed):
    code, doc, hdrs = routed["retry"]
    assert code == 200 and hdrs["X-Routed-To"] == "r0"
    joined = routed["retry_joined"]
    assert joined["retries"] == 1 and joined["retry_ms"] > 0
    assert any(str(r["phase"]).startswith("proxy_attempt")
               and "draining" in str(r["phase"]) for r in joined["rows"])
    assert routed["counter"] == routed["span_retries"] == 1
    json.dumps(joined)  # the record is JSON all through

"""The port's live exporter on the CPU: `progress_snapshot` against the
reference's on the same span trees; a `LiveTelemetryServer` on port 0
answering /metrics, /metrics.json, /healthz (503 and a flight flush on a
violated verdict), /progress, injected routes, 404, and announcing
itself in live.json; the telemetry session starting and stopping it.
Each HTTP call has its own timeout; nothing here asserts a wall time."""

import json
import os
import sys
import urllib.error
import urllib.request

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from check_report import validate_flight  # noqa: E402

from image_analogies_tpu.telemetry import live as j_live  # noqa: E402
from image_analogies_tpu.telemetry import spans as j_spans  # noqa: E402
from image_analogies_tpu_torch.telemetry import live as t_live  # noqa: E402
from image_analogies_tpu_torch.telemetry import metrics as t_metrics  # noqa: E402
from image_analogies_tpu_torch.telemetry import spans as t_spans  # noqa: E402
from image_analogies_tpu_torch.telemetry.flight import FlightRecorder  # noqa: E402

TIMEOUT = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def plan_tree(spans_mod, walls, plan=True):
    tracer = spans_mod.Tracer()
    if plan:
        tracer.annotate(
            "run_plan", levels=3, shapes=[[64, 64], [32, 32], [16, 16]],
            eta_cost_units={"0": 16.0, "1": 4.0, "2": 1.0},
        )
    for lvl, wall in walls.items():
        tracer.record("level", wall, level=lvl, em_iters=1)
    return tracer


@pytest.mark.parametrize("walls,plan", [
    ({}, True), ({2: 100.0}, True), ({2: 100.0, 1: 400.0}, True),
    ({2: 100.0, 1: 400.0, 0: 1600.0}, True), ({2: 100.0}, False),
    ({2: 80.0, 1: 250.0}, False),
])
def test_progress_snapshot_equals_the_reference(walls, plan):
    got = t_live.progress_snapshot(plan_tree(t_spans, walls, plan))
    want = j_live.progress_snapshot(plan_tree(j_spans, walls, plan))
    assert got == want


def test_progress_snapshot_stack_names_the_open_spans():
    out = {}
    for name, mod in (("torch", t_spans), ("jax", j_spans)):
        tracer = plan_tree(mod, {2: 100.0})
        with tracer.span("run"):
            with tracer.span("level", level=1):
                snap = (t_live if name == "torch" else
                        j_live).progress_snapshot(tracer)
        out[name] = [s["name"] for s in snap["stack"]]
        assert snap["eta_s"] is not None
    assert out["torch"] == out["jax"] == ["run", "level"]


@pytest.fixture
def server():
    started = []

    def start(tracer=None, reg=None, **kw):
        reg = reg if reg is not None else t_metrics.MetricsRegistry()
        tracer = tracer if tracer is not None else t_spans.Tracer(
            registry=reg)
        srv = t_live.LiveTelemetryServer(tracer, reg, port=0, **kw).start()
        started.append(srv)
        return srv

    yield start
    for srv in started:
        srv.stop()


def test_metrics_endpoints(server):
    reg = t_metrics.MetricsRegistry()
    reg.counter("req_total", "r").inc(2)
    reg.histogram("lat_ms", buckets=(1.0, 10.0)).observe(3.0)
    srv = server(reg=reg)
    code, ctype, body = _get(srv.url + "/metrics")
    assert code == 200 and "version=0.0.4" in ctype
    assert body.decode() == reg.to_prometheus()
    assert "req_total 2" in body.decode()
    code, ctype, body = _get(srv.url + "/metrics.json")
    assert code == 200 and ctype == "application/json"
    assert json.loads(body) == reg.to_dict()


def test_healthz_ok_on_a_clean_registry(server):
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        from image_analogies_tpu_torch.kernels.patchmatch_tile import (
            book_launch,
        )

        book_launch(100, 4, 16, 2, "bf16")
    finally:
        t_metrics.set_registry(prev)
    srv = server(reg=reg)
    code, _, body = _get(srv.url + "/healthz")
    health = json.loads(body)
    assert code == 200 and health["verdict"] == "ok"
    assert health["context"] == "live"
    by = {c["name"]: c["status"] for c in health["checks"]}
    assert by["candidate_dma_model"] == "ok"
    assert by["span_tree"] == "skipped"  # end-of-run only


def test_healthz_violation_returns_503_and_flushes_flight(server, tmp_path):
    reg = t_metrics.MetricsRegistry()
    # Bytes that disagree with their fetch count by one.
    reg.counter("ia_candidate_dma_bytes_total").inc(
        1.0, labels={"kind": "useful", "dtype": "bf16"})
    reg.counter("ia_candidate_dma_fetches_total").inc(
        1, labels={"chan": "4", "rows": "16", "halo": "2", "dtype": "bf16"})
    tracer = t_spans.Tracer(registry=reg)
    rec = FlightRecorder(tracer, reg, str(tmp_path / "flight.json"))
    srv = server(tracer=tracer, reg=reg, flight=rec)
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(srv.url + "/healthz")
    assert err.value.code == 503
    assert json.loads(err.value.read())["verdict"] == "violated"
    dump = json.load(open(rec.path))
    assert dump["flushed_on"] == "violation"
    assert validate_flight(dump) == []


def test_progress_endpoint_and_404(server):
    tracer = plan_tree(t_spans, {2: 100.0})
    srv = server(tracer=tracer)
    code, _, body = _get(srv.url + "/progress")
    assert code == 200
    assert json.loads(body) == t_live.progress_snapshot(tracer)
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(srv.url + "/nope")
    assert err.value.code == 404


def test_injected_routes_and_health_callback(server):
    def hello(body, headers, ctx):
        return 200, json.dumps({"q": ctx["query"]}).encode(), \
            "application/json", {"X-Test": "1"}

    srv = server(routes={("GET", "/hello"): hello},
                 health_cb=lambda: {"verdict": "degraded", "checks": []})
    with urllib.request.urlopen(srv.url + "/hello?a=1&a=2",
                                timeout=TIMEOUT) as r:
        assert r.headers["X-Test"] == "1"
        assert json.loads(r.read()) == {"q": {"a": "2"}}
    code, _, body = _get(srv.url + "/healthz")
    assert code == 200 and json.loads(body)["verdict"] == "degraded"


def test_announce_writes_live_json(server, tmp_path):
    srv = server()
    srv.announce(str(tmp_path))
    info = json.load(open(tmp_path / t_live.LIVE_FILE))
    assert info["url"] == srv.url and info["port"] == srv.port > 0
    assert info["pid"] == os.getpid()
    assert info["endpoints"] == ["/metrics", "/metrics.json", "/healthz",
                                 "/progress"]


def test_session_serves_while_open_and_stops(tmp_path):
    from image_analogies_tpu_torch.utils.profiling import telemetry_session

    with telemetry_session(None, artifact_dir=str(tmp_path),
                           metrics_port=0) as tracer:
        info = json.load(open(tmp_path / t_live.LIVE_FILE))
        with tracer.span("run"):
            code, _, body = _get(info["url"] + "/progress")
            assert code == 200
            assert [s["name"] for s in json.loads(body)["stack"]] == ["run"]
        code, _, _ = _get(info["url"] + "/metrics")
        assert code == 200
    with pytest.raises(urllib.error.URLError):
        _get(info["url"] + "/metrics")
    assert validate_flight(json.load(open(tmp_path / "flight.json"))) == []


def test_disabled_session_starts_no_server(tmp_path):
    from image_analogies_tpu_torch.utils.profiling import telemetry_session

    with telemetry_session(None, enabled=False, artifact_dir=str(tmp_path),
                           metrics_port=0) as tracer:
        assert not tracer.enabled
    assert not (tmp_path / t_live.LIVE_FILE).exists()

"""The serving observatory's single-daemon half on the port, on the
CPU: the reference's time-series ring and anomaly-detector cases
(tests/test_observatory.py) against `telemetry/timeseries.py` and
`telemetry/anomaly.py`, the window and the watches equal to the JAX
package's on the same snapshots, the flight-ring capacity resolution,
and a port daemon's `/obs/window`, `/request` and `trace --url`.  The
fleet aggregator (`serving/observatory.py`) is ROADMAP Queue 1 step
13b's."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from image_analogies_tpu.telemetry import anomaly as j_anomaly
from image_analogies_tpu.telemetry import metrics as j_metrics
from image_analogies_tpu.telemetry import timeseries as j_ts
from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.serving.daemon import SynthDaemon
from image_analogies_tpu_torch.telemetry.anomaly import (
    ANOMALY_STATUS_GAUGE,
    AnomalyConfig,
    AnomalyDetector,
    baseline_from_record,
)
from image_analogies_tpu_torch.telemetry.flight import (
    DEFAULT_RING_CAPACITY,
    RING_CAPACITY_ENV,
    FlightRecorder,
    resolve_ring_capacity,
)
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.sentinel import check_anomaly
from image_analogies_tpu_torch.telemetry.slo import (
    REQUEST_DURATION_METRIC,
    quantile_from_cell,
)
from image_analogies_tpu_torch.telemetry.timeseries import (
    TimeSeriesRing,
    compute_window,
    counter_increase,
)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_SERVE_CFG = dict(
    levels=2, matcher="patchmatch", pallas_mode="off",
    em_iters=1, pm_iters=2, device="cpu",
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ synthetic snapshots
def _counter_snap(value, name="ia_x_total"):
    return {name: {"kind": "counter", "help": "", "values":
                   {"total": value}}}


def _hist_snap(count, total, buckets, name=REQUEST_DURATION_METRIC,
               label='{outcome="ok"}'):
    return {name: {"kind": "histogram", "help": "", "values": {
        label: {"count": count, "sum": total, "buckets": buckets},
    }}}


class TestComputeWindow:
    def test_ok_rates(self):
        snaps = [(0.0, _counter_snap(4)), (5.0, _counter_snap(14))]
        w = compute_window(snaps, None)
        assert w["status"] == "ok" and w["window_s"] == 5.0
        cell = w["counters"]["ia_x_total"]["total"]
        assert cell == {"cumulative": 14, "increase": 10,
                        "rate_per_s": 2.0}
        assert w["resets"] == 0

    def test_counter_reset_never_negative(self):
        # Restart/takeover: the counter went BACKWARDS (14 -> 3).  The
        # Prometheus increase() rule applies: the post-reset cumulative
        # IS the in-window increase — never a negative rate.
        snaps = [(0.0, _counter_snap(14)), (4.0, _counter_snap(3))]
        w = compute_window(snaps, None)
        cell = w["counters"]["ia_x_total"]["total"]
        assert cell["increase"] == 3 and cell["rate_per_s"] == 0.75
        assert w["resets"] >= 1
        inc, reset = counter_increase(3, 14)
        assert (inc, reset) == (3, True)

    def test_histogram_reset(self):
        before = _hist_snap(10, 500.0, {"50": 8, "+Inf": 10})
        after = _hist_snap(2, 20.0, {"50": 2, "+Inf": 2})
        w = compute_window([(0.0, before), (2.0, after)], None)
        cell = w["histograms"][REQUEST_DURATION_METRIC]['{outcome="ok"}']
        assert cell["count"] == 2 and cell["buckets"]["50"] == 2
        assert w["resets"] >= 1

    def test_empty_is_no_data(self):
        w = compute_window([], None)
        assert w["status"] == "no_data"
        assert w["counters"] == {} and w["gauges"] == {}
        assert w["histograms"] == {}

    def test_single_snapshot_imputes_nothing(self):
        w = compute_window([(3.0, _counter_snap(9))], None)
        assert w["status"] == "single_snapshot"
        cell = w["counters"]["ia_x_total"]["total"]
        assert cell["cumulative"] == 9
        assert cell["increase"] is None and cell["rate_per_s"] is None

    def test_zero_width_window_is_single_snapshot(self):
        snaps = [(5.0, _counter_snap(1)), (5.0, _counter_snap(2))]
        assert compute_window(snaps, None)["status"] == "single_snapshot"

    def test_span_selects_base(self):
        snaps = [(0.0, _counter_snap(0)), (10.0, _counter_snap(100)),
                 (20.0, _counter_snap(130))]
        w = compute_window(snaps, 12.0)
        # Base = oldest snapshot within 12 s of the newest: t=10.
        assert w["counters"]["ia_x_total"]["total"]["increase"] == 30
        full = compute_window(snaps, None)
        assert full["counters"]["ia_x_total"]["total"]["increase"] == 130

    def test_window_quantiles_match_delta_cell(self):
        before = _hist_snap(0, 0.0, {"10": 0, "100": 0, "+Inf": 0})
        after = _hist_snap(8, 400.0, {"10": 2, "100": 8, "+Inf": 8})
        w = compute_window([(0.0, before), (4.0, after)], None)
        cell = w["histograms"][REQUEST_DURATION_METRIC]['{outcome="ok"}']
        delta = {"count": 8, "sum": 400.0,
                 "buckets": {"10": 2, "100": 8, "+Inf": 8}}
        assert cell["p99"] == quantile_from_cell(delta, 0.99)
        assert cell["p50"] == quantile_from_cell(delta, 0.5)
        assert cell["rate_per_s"] == 2.0


class TestTimeSeriesRing:
    def test_capacity_bound(self):
        ring = TimeSeriesRing(MetricsRegistry(), interval_s=1.0,
                              capacity=5)
        for i in range(12):
            ring.tick(now=float(i))
        assert len(ring) == 5
        assert ring.window(None)["ticks_total"] == 12

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            TimeSeriesRing(MetricsRegistry(), capacity=0)

    def test_reset_rebase_excludes_pre_epoch_traffic(self):
        reg = MetricsRegistry()
        c = reg.counter("ia_warm_total")
        ring = TimeSeriesRing(reg, interval_s=1.0, capacity=16)
        ring.tick(now=0.0)
        c.inc(100)  # warmup sweep — must not appear in served windows
        # rebase=True snapshots the post-warmup state as the new base.
        ring.reset(now=5.0)
        assert len(ring) == 1
        c.inc(7)
        ring.tick(now=10.0)
        w = ring.window(None)
        assert w["status"] == "ok"
        assert w["counters"]["ia_warm_total"]["total"]["increase"] == 7

    def test_reset_without_rebase_clears(self):
        ring = TimeSeriesRing(MetricsRegistry(), capacity=4)
        ring.tick(now=0.0)
        ring.reset(rebase=False)
        assert len(ring) == 0
        assert ring.window(None)["status"] == "no_data"

    def test_sampler_ticks_and_calls_hook(self):
        reg = MetricsRegistry()
        ring = TimeSeriesRing(reg, interval_s=0.02, capacity=64)
        hook_calls = []
        ring.start_sampler(on_tick=lambda: hook_calls.append(1))
        ring.start_sampler()  # idempotent
        deadline = time.monotonic() + 5.0
        while len(ring) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        ring.stop_sampler()
        assert len(ring) >= 3 and len(hook_calls) >= 3
        n = len(ring)
        time.sleep(0.06)
        assert len(ring) == n  # really stopped

    def test_sampler_survives_hook_exception(self):
        ring = TimeSeriesRing(MetricsRegistry(), interval_s=0.02,
                              capacity=64)

        def bad_hook():
            raise RuntimeError("observer must never kill the daemon")

        ring.start_sampler(on_tick=bad_hook)
        deadline = time.monotonic() + 5.0
        while len(ring) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        ring.stop_sampler()
        assert len(ring) >= 2


def _ring_with(reg, mutate, t0=0.0, t1=10.0):
    """Two-snapshot ring: base at t0, `mutate(reg)` traffic, tip at
    t1 — the smallest window that grades 'ok'."""
    ring = TimeSeriesRing(reg, interval_s=5.0, capacity=16)
    ring.tick(now=t0)
    mutate(reg)
    ring.tick(now=t1)
    return ring


class TestAnomalyDetector:
    def _duration(self, reg):
        return reg.histogram(REQUEST_DURATION_METRIC, "t",
                             buckets=(10.0, 100.0, 1000.0))

    def test_latency_fires_past_envelope(self):
        reg = MetricsRegistry()
        ring = _ring_with(reg, lambda r: [
            self._duration(r).observe(900.0, labels={"outcome": "ok"})
            for _ in range(4)
        ])
        det = AnomalyDetector(
            ring, reg, AnomalyConfig(baseline_p99_ms=10.0,
                                     p99_envelope_mult=10.0),
        )
        rep = det.evaluate()
        watch = {w["watch"]: w for w in rep["watches"]}["latency_p99"]
        assert watch["status"] == "firing"
        assert rep["verdict"] == "firing"
        assert "latency_p99" in rep["firing"]

    def test_latency_ok_inside_envelope(self):
        reg = MetricsRegistry()
        ring = _ring_with(reg, lambda r: [
            self._duration(r).observe(5.0, labels={"outcome": "ok"})
            for _ in range(4)
        ])
        det = AnomalyDetector(
            ring, reg, AnomalyConfig(baseline_p99_ms=10.0),
        )
        rep = det.evaluate()
        watch = {w["watch"]: w for w in rep["watches"]}["latency_p99"]
        assert watch["status"] == "ok" and rep["firing"] == []

    def test_latency_no_baseline_is_no_data(self):
        reg = MetricsRegistry()
        ring = _ring_with(reg, lambda r: self._duration(r).observe(
            5.0, labels={"outcome": "ok"}))
        rep = AnomalyDetector(ring, reg, AnomalyConfig()).evaluate()
        watch = {w["watch"]: w for w in rep["watches"]}["latency_p99"]
        assert watch["status"] == "no_data"

    def test_miss_storm_fires_on_client_misses(self):
        reg = MetricsRegistry()

        def storm(r):
            r.counter("ia_serve_excache_misses_total").inc(
                9, labels={"kind": "client"})
            r.counter("ia_serve_excache_hits_total").inc(
                1, labels={"kind": "client"})

        det = AnomalyDetector(_ring_with(reg, storm), reg)
        rep = det.evaluate()
        watch = {w["watch"]: w
                 for w in rep["watches"]}["excache_miss_storm"]
        assert watch["status"] == "firing"

    def test_miss_storm_ignores_warmup_kind(self):
        reg = MetricsRegistry()

        def warmup(r):
            r.counter("ia_serve_excache_misses_total").inc(
                50, labels={"kind": "warmup"})

        rep = AnomalyDetector(_ring_with(reg, warmup), reg).evaluate()
        watch = {w["watch"]: w
                 for w in rep["watches"]}["excache_miss_storm"]
        assert watch["status"] == "no_data"  # 0 client dispatches

    def test_miss_storm_min_dispatch_guard(self):
        reg = MetricsRegistry()

        def trickle(r):
            r.counter("ia_serve_excache_misses_total").inc(
                3, labels={"kind": "client"})

        rep = AnomalyDetector(_ring_with(reg, trickle), reg).evaluate()
        watch = {w["watch"]: w
                 for w in rep["watches"]}["excache_miss_storm"]
        assert watch["status"] == "no_data"

    def test_queue_saturation(self):
        reg = MetricsRegistry()
        ring = _ring_with(
            reg, lambda r: r.gauge("ia_serve_queue_depth").set(4))
        rep = AnomalyDetector(ring, reg, max_queue_depth=4).evaluate()
        watch = {w["watch"]: w
                 for w in rep["watches"]}["queue_saturation"]
        assert watch["status"] == "firing"
        rep2 = AnomalyDetector(ring, reg).evaluate()  # depth unknown
        watch2 = {w["watch"]: w
                  for w in rep2["watches"]}["queue_saturation"]
        assert watch2["status"] == "no_data"

    def test_shape_cardinality(self):
        reg = MetricsRegistry()
        ring = _ring_with(
            reg,
            lambda r: r.gauge("ia_serve_shape_cardinality").set(30))
        rep = AnomalyDetector(
            ring, reg, AnomalyConfig(shape_card_max=24)).evaluate()
        watch = {w["watch"]: w
                 for w in rep["watches"]}["shape_cardinality"]
        assert watch["status"] == "firing"

    def test_empty_ring_is_all_no_data(self):
        reg = MetricsRegistry()
        ring = TimeSeriesRing(reg, capacity=4)
        rep = AnomalyDetector(ring, reg).evaluate()
        assert rep["verdict"] == "no_data"
        assert all(w["status"] == "no_data" for w in rep["watches"])

    def test_gauges_published_and_sentinel_grades(self):
        reg = MetricsRegistry()
        ring = _ring_with(
            reg,
            lambda r: r.gauge("ia_serve_shape_cardinality").set(99))
        AnomalyDetector(
            ring, reg, AnomalyConfig(shape_card_max=24)).evaluate()
        metrics = reg.to_dict()
        vals = metrics[ANOMALY_STATUS_GAUGE]["values"]
        assert vals['{watch="shape_cardinality"}'] == 1.0
        chk = check_anomaly(metrics)
        assert chk["status"] == "degraded"
        assert "shape_cardinality" in chk["detail"]

    def test_sentinel_skips_without_detector(self):
        assert check_anomaly({})["status"] == "skipped"
        assert check_anomaly(None)["status"] == "skipped"

    def test_baseline_from_record(self, tmp_path):
        p = tmp_path / "rec.json"
        p.write_text(json.dumps({"pipeline": {"p99_warm_ms": 81.5}}))
        assert baseline_from_record(str(p)) == 81.5
        assert baseline_from_record(str(tmp_path / "nope.json")) is None
        (tmp_path / "bad.json").write_text("{not json")
        assert baseline_from_record(str(tmp_path / "bad.json")) is None
        committed = baseline_from_record(
            os.path.join(_ROOT, "SERVE_r18.json"))
        assert committed is not None and committed > 0


# ------------------------------------------------- flight-ring capacity
class TestFlightRingCapacity:
    def test_default(self, monkeypatch):
        monkeypatch.delenv(RING_CAPACITY_ENV, raising=False)
        assert resolve_ring_capacity() == DEFAULT_RING_CAPACITY == 512

    def test_env_and_cli_precedence(self, monkeypatch):
        monkeypatch.setenv(RING_CAPACITY_ENV, "64")
        assert resolve_ring_capacity() == 64
        assert resolve_ring_capacity(cli_value=128) == 128  # CLI wins

    def test_malformed_env_falls_back(self, monkeypatch):
        monkeypatch.setenv(RING_CAPACITY_ENV, "lots")
        assert resolve_ring_capacity() == DEFAULT_RING_CAPACITY
        monkeypatch.setenv(RING_CAPACITY_ENV, "-3")
        assert resolve_ring_capacity() == DEFAULT_RING_CAPACITY

    def test_recorder_default_capacity(self):
        from image_analogies_tpu_torch.telemetry.spans import Tracer

        fr = FlightRecorder(Tracer(registry=MetricsRegistry()))
        assert fr.capacity == DEFAULT_RING_CAPACITY


# ------------------------------------------------ against the JAX ring
def _traffic(reg, step):
    """One interval of serving-like traffic on either package's
    registry: counters (one reset after step 2), a duration histogram,
    gauges."""
    c = reg.counter("ia_serve_excache_misses_total", "m")
    h = reg.counter("ia_serve_excache_hits_total", "h")
    d = reg.histogram(REQUEST_DURATION_METRIC, "t",
                      buckets=(10.0, 100.0, 1000.0))
    c.inc(1 + step, labels={"kind": "client"})
    h.inc(3 * step, labels={"kind": "client"})
    for v in (5.0 * (step + 1), 80.0, 400.0 + step):
        d.observe(v, labels={"outcome": "ok", "cache": "hit"})
    reg.gauge("ia_serve_queue_depth", "q").set(float(step % 4))
    reg.gauge("ia_serve_shape_cardinality", "s").set(float(3 * step))


@pytest.mark.parametrize("span", [None, 7.5, 20.0, 1.0])
def test_window_and_watches_equal_jax(span):
    """The same traffic, ticked at the same clocks into each package's
    ring: the same window document and the same anomaly report."""
    docs = []
    for mod_m, mod_t, mod_a in (
            (j_metrics, j_ts, j_anomaly),
            (__import__("image_analogies_tpu_torch.telemetry.metrics",
                        fromlist=["x"]),
             __import__("image_analogies_tpu_torch.telemetry.timeseries",
                        fromlist=["x"]),
             __import__("image_analogies_tpu_torch.telemetry.anomaly",
                        fromlist=["x"]))):
        reg = mod_m.MetricsRegistry()
        ring = mod_t.TimeSeriesRing(reg, interval_s=5.0, capacity=4)
        for step in range(6):
            _traffic(reg, step)
            ring.tick(now=5.0 * step)
        det = mod_a.AnomalyDetector(
            ring, reg, mod_a.AnomalyConfig(baseline_p99_ms=50.0,
                                           shape_card_max=10,
                                           window_s=span),
            max_queue_depth=3)
        docs.append((ring.window(span), det.evaluate()))
    assert docs[1] == docs[0]


# ------------------------------------------------------ port daemon
def _body(frame):
    import base64

    return json.dumps({
        "image_b64": base64.b64encode(
            np.ascontiguousarray(frame).tobytes()).decode(),
        "shape": list(frame.shape), "dtype": "float32",
    }).encode()


def _get(url, timeout=30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def obs_daemon():
    rng = np.random.default_rng(19)
    a, ap, b = (rng.random((24, 24, 3)).astype(np.float32)
                for _ in range(3))
    reg = MetricsRegistry()
    prev = set_registry(reg)
    d = SynthDaemon(a, ap, SynthConfig(**_SERVE_CFG), registry=reg,
                    max_batch=1, max_wait_ms=5.0,
                    obs_interval_s=0.05).start()
    try:
        req = urllib.request.Request(
            d.url + "/synthesize", data=_body(b), method="POST",
            headers={"X-Request-Id": "obs-pin-1"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
        deadline = time.monotonic() + 10.0
        while len(d.obs) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        yield d, (a, ap)
    finally:
        d.stop()
        set_registry(prev)


class TestObservatoryLive:
    def test_obs_window_endpoint_span_and_errors(self, obs_daemon):
        d, _ = obs_daemon
        code, raw = _get(d.url + "/obs/window?span=60")
        assert code == 200
        w = json.loads(raw)
        assert w["kind"] == "obs_window"
        assert w["requested_span_s"] == 60.0
        assert w["status"] in ("ok", "single_snapshot")
        code, raw = _get(d.url + "/obs/window")
        w = json.loads(raw)
        assert w["status"] == "ok"
        ok = w["counters"]["ia_serve_completed_total"]["total"]
        assert ok["cumulative"] == 1
        for bad in ("abc", "-5", "0"):
            code, _ = _get(d.url + f"/obs/window?span={bad}")
            assert code == 400

    def test_anomalies_ride_slo(self, obs_daemon):
        d, _ = obs_daemon
        code, raw = _get(d.url + "/slo")
        rep = json.loads(raw)["anomalies"]
        assert rep["firing"] == []
        assert {w["watch"] for w in rep["watches"]} >= {
            "latency_p99", "excache_miss_storm", "queue_saturation",
            "shape_cardinality",
        }

    def test_obs_window_404_when_disabled(self, obs_daemon):
        _, (a, ap) = obs_daemon
        d = SynthDaemon(
            a, ap, SynthConfig(**_SERVE_CFG), registry=MetricsRegistry(),
            obs_interval_s=0.0,
        ).start()
        try:
            code, raw = _get(d.url + "/obs/window")
            assert code == 404
            assert "error" in json.loads(raw)
        finally:
            d.stop()

    def test_request_endpoint_roundtrip(self, obs_daemon):
        d, _ = obs_daemon
        code, raw = _get(d.url + "/request?id=obs-pin-1")
        assert code == 200
        doc = json.loads(raw)
        assert doc["request"]["request_id"] == "obs-pin-1"
        assert doc["request"]["outcome"] == "ok"
        code, _ = _get(d.url + "/request?id=never-seen")
        assert code == 404
        code, _ = _get(d.url + "/request")
        assert code == 400

    def test_trace_cli_against_live_daemon(self, obs_daemon, capsys):
        from image_analogies_tpu_torch import cli

        d, _ = obs_daemon
        rc = cli.main(["trace", "obs-pin-1", "--url", d.url])
        assert rc == 0
        out = capsys.readouterr().out
        assert "obs-pin-1" in out and "outcome=ok" in out
        with pytest.raises(SystemExit, match="404"):
            cli.main(["trace", "never-seen", "--url", d.url])
        with pytest.raises(SystemExit, match="exactly one"):
            cli.main(["trace", "x", "--url", d.url,
                      "--trace-dir", "/tmp"])

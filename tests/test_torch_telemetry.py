"""The port's telemetry against the reference's, on the CPU: the metrics
registry's cases of tests/test_telemetry.py (counters, gauges,
histograms, quantiles, the Prometheus and JSON expositions, hostile
labels) and the tracer's, each run on both packages' classes with the
same calls and equal `to_dict()` / `to_prometheus()` output; a traced
port run's span tree against the JAX run's on the same config (span
names, nesting, `em_iters` declarations); the registry counters of a
traced run; and the port's flight dump through the repository's own
validator (tools/check_report.py `validate_flight`)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from check_report import validate_flight  # noqa: E402

from image_analogies_tpu import SynthConfig as JCfg  # noqa: E402
from image_analogies_tpu import create_image_analogy as j_create  # noqa: E402
from image_analogies_tpu.telemetry import metrics as j_metrics  # noqa: E402
from image_analogies_tpu.telemetry import spans as j_spans  # noqa: E402
from image_analogies_tpu_torch import SynthConfig  # noqa: E402
from image_analogies_tpu_torch import create_image_analogy  # noqa: E402
from image_analogies_tpu_torch.telemetry import metrics as t_metrics  # noqa: E402
from image_analogies_tpu_torch.telemetry import spans as t_spans  # noqa: E402
from image_analogies_tpu_torch.telemetry.flight import FlightRecorder  # noqa: E402

PACKAGES = {"jax": (j_metrics, j_spans), "torch": (t_metrics, t_spans)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- the registry
# Each case takes a metrics module, makes its calls, checks the
# reference's assertions and returns the registry for the cross-package
# comparison.


def case_counter_inc_and_labels(m):
    reg = m.MetricsRegistry()
    c = reg.counter("c_total", "help text")
    c.inc()
    c.inc(2)
    c.inc(labels={"kernel": "tile_sweep"})
    assert c.value() == 3
    assert c.value(labels={"kernel": "tile_sweep"}) == 1
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg


def case_gauge_last_write_wins(m):
    reg = m.MetricsRegistry()
    g = reg.gauge("g")
    assert g.value() is None
    g.set(1.5)
    g.set(2.5)
    assert g.value() == 2.5
    return reg


def case_histogram_cumulative_buckets(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("h_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    assert h.count() == 4
    assert h.sum() == 555.5
    assert h.to_dict()["total"]["buckets"] == {"1.0": 1, "10.0": 2,
                                               "100.0": 3}
    return reg


def case_kind_collision_rejected(m):
    reg = m.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    return reg


def case_get_or_create_returns_same_object(m):
    reg = m.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    return reg


def case_prometheus_exposition_format(m):
    reg = m.MetricsRegistry()
    reg.counter("req_total", "requests").inc(3)
    reg.gauge("temp").set(1.5, labels={"level": "0"})
    reg.histogram("lat_ms", buckets=(10.0,)).observe(5.0)
    text = reg.to_prometheus()
    for line in ("# HELP req_total requests", "# TYPE req_total counter",
                 "req_total 3", 'temp{level="0"} 1.5',
                 'lat_ms_bucket{le="10"} 1', 'lat_ms_bucket{le="+Inf"} 1',
                 "lat_ms_sum 5", "lat_ms_count 1"):
        assert line in text
    return reg


def case_json_exposition_shape(m):
    reg = m.MetricsRegistry()
    reg.counter("c", "ch").inc()
    assert reg.to_dict()["c"] == {"kind": "counter", "help": "ch",
                                  "values": {"total": 1.0}}
    return reg


def case_hostile_label_value_round_trips(m):
    hostile = 'pa\\th "quoted"\nline2\\n-literal'
    reg = m.MetricsRegistry()
    reg.counter("req_total", "requests").inc(
        2, labels={"path": hostile, "code": "200"})
    text = reg.to_prometheus()
    line = [ln for ln in text.splitlines()
            if ln.startswith("req_total{")][0]
    assert "\n" not in line
    assert '\\n' in line and '\\"' in line and "\\\\" in line
    label_str = next(iter(reg.to_dict()["req_total"]["values"]))
    assert m.parse_label_str(label_str) == {"path": hostile, "code": "200"}
    assert m.unescape_label_value(m.escape_label_value(hostile)) == hostile
    return reg


def case_type_line_exactly_once_per_family(m):
    reg = m.MetricsRegistry()
    c = reg.counter("req_total", "requests")
    for code in ("200", "404", "500"):
        c.inc(labels={"code": code})
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v, labels={"route": "a"})
        h.observe(v, labels={"route": "b"})
    text = reg.to_prometheus()
    assert text.count("# TYPE req_total counter") == 1
    assert text.count("# TYPE lat_ms histogram") == 1
    assert "# TYPE lat_ms_bucket" not in text
    assert text.count("# TYPE lat_ms_quantile gauge") == 1
    assert text.count("# TYPE") == 3
    assert text.count("lat_ms_bucket{") == 6
    assert text.count("lat_ms_quantile{") == 4
    return reg


def case_quantile_interpolation(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("h_ms", buckets=(10.0, 100.0))
    for _ in range(8):
        h.observe(5.0)
    for _ in range(2):
        h.observe(50.0)
    assert h.quantile(0.5) == pytest.approx(6.25)
    assert h.quantile(0.99) == pytest.approx(95.5)
    h.observe(1e9)
    assert h.quantile(0.99) == 100.0
    assert reg.histogram("empty").quantile(0.5) is None
    with pytest.raises(ValueError):
        h.quantile(1.5)
    return reg


def case_quantile_family_hostile_labels_round_trip(m):
    hostile = 'sl\\ab "q"\nband'
    reg = m.MetricsRegistry()
    reg.histogram("w_ms", buckets=(10.0,)).observe(
        5.0, labels={"shard": hostile})
    qlines = [ln for ln in reg.to_prometheus().splitlines()
              if ln.startswith("w_ms_quantile{")]
    assert len(qlines) == 2
    for ln in qlines:
        labels = m.parse_label_str(
            ln[len("w_ms_quantile"):].rsplit(" ", 1)[0])
        assert labels["shard"] == hostile
        assert labels["quantile"] in ("0.5", "0.99")
    return reg


def case_quantile_family_yields_to_real_metric(m):
    reg = m.MetricsRegistry()
    reg.histogram("x_ms", buckets=(10.0,)).observe(5.0)
    reg.gauge("x_ms_quantile").set(1.0)
    assert reg.to_prometheus().count("# TYPE x_ms_quantile") == 1
    return reg


def case_help_line_escapes_newlines(m):
    reg = m.MetricsRegistry()
    reg.counter("c_total", "line1\nline2 \\ backslash").inc()
    (help_line,) = [ln for ln in reg.to_prometheus().splitlines()
                    if ln.startswith("# HELP")]
    assert help_line == "# HELP c_total line1\\nline2 \\\\ backslash"
    return reg


REGISTRY_CASES = [v for k, v in sorted(globals().items())
                  if k.startswith("case_")]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", REGISTRY_CASES,
                         ids=lambda f: f.__name__[len("case_"):])
def test_registry_case(case, pkg):
    """The reference's assertions hold on either package's registry."""
    case(PACKAGES[pkg][0])


@pytest.mark.parametrize("case", REGISTRY_CASES,
                         ids=lambda f: f.__name__[len("case_"):])
def test_registry_expositions_equal_across_packages(case):
    """The same calls give the same JSON and Prometheus expositions."""
    j, t = case(j_metrics), case(t_metrics)
    assert t.to_dict() == j.to_dict()
    assert t.to_prometheus() == j.to_prometheus()


def test_kernel_launch_counter_books_the_session_registry():
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        t_metrics.count_kernel_launch("tile_sweep")
        t_metrics.count_kernel_launch("tile_sweep")
        t_metrics.count_kernel_launch("exact_nn")
    finally:
        t_metrics.set_registry(prev)
    c = reg.counter("ia_kernel_launches_total")
    assert c.value(labels={"kernel": "tile_sweep"}) == 2
    assert c.value(labels={"kernel": "exact_nn"}) == 1


def test_cpu_runs_book_no_kernel_launch():
    """CPU tensors run the plain versions: no launch is booked."""
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        rng = np.random.default_rng(0)
        a = rng.random((32, 32)).astype(np.float32)
        create_image_analogy(a, a, a, SynthConfig(
            device="cpu", levels=1, matcher="brute", em_iters=1))
    finally:
        t_metrics.set_registry(prev)
    assert "ia_kernel_launches_total" not in reg.to_dict()


# ------------------------------------------------------------- the tracer


def tcase_nesting_follows_context_stack(s):
    tr = s.Tracer()
    with tr.span("run"):
        with tr.span("level", level=0):
            tr.emit("resume", from_level=1)
    (run,) = tr.roots
    assert run.name == "run"
    (level,) = run.children
    assert level.name == "level"
    assert [c.name for c in level.children] == ["resume"]


def tcase_legacy_event_view_on_span_close(s):
    events = []

    class Sink:
        def emit(self, event, **fields):
            events.append((event, fields))

    tr = s.Tracer(sink=Sink())
    with tr.span("level", level=3, shape=[8, 8]) as sp:
        sp.set(nnf_energy=0.5)
    (event, fields) = events[0]
    assert event == "level_done"
    assert fields["level"] == 3 and fields["nnf_energy"] == 0.5
    assert fields["wall_ms"] >= 0.0


def tcase_record_is_timed_and_emits(s):
    tr = s.Tracer()
    sp = tr.record("prologue", 123.456)
    assert sp.wall_ms == pytest.approx(123.456, abs=0.01)
    assert tr.find("prologue") == [sp]


def tcase_to_dict_round_trips_schema(s):
    tr = s.Tracer()
    with tr.span("run"):
        tr.annotate("em_iter", em=0)
    d = tr.to_dict()
    assert d["schema_version"] == 1
    (run,) = d["spans"]
    assert run["name"] == "run" and run["wall_ms"] is not None
    (em,) = run["children"]
    assert em["wall_ms"] is None


TRACER_CASES = [v for k, v in sorted(globals().items())
                if k.startswith("tcase_")]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", TRACER_CASES,
                         ids=lambda f: f.__name__[len("tcase_"):])
def test_tracer_case(case, pkg):
    case(PACKAGES[pkg][1])


def test_disabled_tracer_is_free():
    """A disabled tracer hands out one shared no-op span and records
    nothing."""
    tr = t_spans.as_tracer(None)
    assert tr is t_spans.NULL_TRACER and not tr.enabled
    assert tr.span("level") is tr.span("run")
    tr.emit("start")
    assert tr.roots == []


# ---------------------------------------------- a traced run, both packages


def _skeleton(spans):
    """(name, declared em_iters, children) of a span forest; marks of
    ad-hoc events are kept, attributes other than `em_iters` dropped."""
    return [
        (s["name"], s["attrs"].get("em_iters"),
         _skeleton(s.get("children", [])))
        for s in spans
    ]


@pytest.fixture(scope="module")
def traced_runs():
    rng = np.random.default_rng(3)
    a = rng.random((32, 32)).astype(np.float32)
    ap = np.clip(a * 0.5 + 0.2, 0, 1).astype(np.float32)
    b = rng.random((32, 32)).astype(np.float32)
    kw = dict(levels=2, matcher="patchmatch", em_iters=2, pm_iters=2,
              pallas_mode="off")
    j_reg, t_reg = j_metrics.MetricsRegistry(), t_metrics.MetricsRegistry()
    j_tr = j_spans.Tracer(registry=j_reg)
    t_tr = t_spans.Tracer(registry=t_reg)
    j_create(a, ap, b, JCfg(**kw), progress=j_tr)
    create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw),
                         progress=t_tr)
    return (j_tr, j_reg), (t_tr, t_reg)


def _above_the_matcher(spans):
    """A span forest without the children of its `match` spans: the
    matcher's own phases, which the port times and the reference does
    not record."""
    return [
        dict(s, children=[] if s["name"] == "match"
             else _above_the_matcher(s.get("children", [])))
        for s in spans
    ]


def test_span_tree_matches_the_reference(traced_runs):
    """Equal down to the EM steps' phases; below `match` the port has
    the matcher's phases (here the per-pixel sweeps, 32² being under
    the tile path's 128)."""
    (j_tr, _), (t_tr, _) = traced_runs
    j_tree, t_tree = j_tr.to_dict(), t_tr.to_dict()
    assert t_tree["schema_version"] == j_tree["schema_version"]
    assert (_skeleton(_above_the_matcher(t_tree["spans"]))
            == _skeleton(j_tree["spans"]))
    assert {tuple(c.name for c in sp.children)
            for sp in t_tr.find("match")} == {("pixel",)}
    (run,) = t_tree["spans"]
    levels = [s for s in run["children"] if s["name"] == "level"]
    assert [s["attrs"]["level"] for s in levels] == [1, 0]
    for lv in levels:
        assert lv["wall_ms"] is not None and lv["attrs"]["em_iters"] == 2
        assert len(lv["children"]) == 2
    (plan,) = [s for s in run["children"] if s["name"] == "run_plan"]
    assert plan["attrs"]["shapes"] == [[32, 32], [16, 16]]
    j_plan = [s for s in j_tree["spans"][0]["children"]
              if s["name"] == "run_plan"][0]
    assert plan["attrs"]["eta_cost_units"] == j_plan["attrs"]["eta_cost_units"]


def test_run_counters_match_the_reference(traced_runs):
    """The level counters of the same run: names and counts equal (the
    energies and walls are the runs' own)."""
    (_, j_reg), (_, t_reg) = traced_runs
    j_d, t_d = j_reg.to_dict(), t_reg.to_dict()
    for name in ("ia_levels_total", "ia_em_iters_total"):
        assert t_d[name] == j_d[name]
    for name in ("ia_nnf_energy", "ia_level_wall_ms"):
        assert t_d[name]["kind"] == j_d[name]["kind"]
        assert set(t_d[name]["values"]) == set(j_d[name]["values"])


def test_flight_dump_passes_the_validator(tmp_path):
    """A flight recorder over a traced port run: its session-end dump is
    valid by tools/check_report.py, and a sticky watchdog reason
    survives the teardown flush."""
    reg = t_metrics.MetricsRegistry()
    tr = t_spans.Tracer(registry=reg)
    path = str(tmp_path / "flight.json")
    rec = FlightRecorder(tr, reg, path, capacity=8).install()
    try:
        rng = np.random.default_rng(0)
        a = rng.random((32, 32)).astype(np.float32)
        create_image_analogy(a, a, a, SynthConfig(
            device="cpu", levels=2, em_iters=1, pm_iters=2), progress=tr)
        rec.flush("watchdog")
    finally:
        rec.uninstall()
    with open(path) as f:
        dump = json.load(f)
    assert validate_flight(dump) == []
    assert dump["flushed_on"] == "watchdog"
    assert dump["dropped_events"] > 0  # the 8-event ring wrapped
    assert dump["metrics"]["ia_levels_total"]["values"] == {"total": 2.0}

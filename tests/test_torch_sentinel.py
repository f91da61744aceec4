"""The port's run sentinel and SLO engine against the reference's, on the
CPU.  Every check that prices no kernel model gets the same `metrics` /
`spans` dicts through both packages' functions and must return an equal
dict, in ok, degraded, violated and skipped cases; `evaluate_health`,
`evaluate_slo` and `quantile_from_cell` likewise.  The three byte-ledger
checks price with the port's own kernels' models: a one-byte drift in a
series is violated, unpriceable labels are violated, a byte series alone
skips; the kernel wrappers book their ledgers (with the library call
replaced, so the bookings run on the CPU) exactly as the sentinel prices
them, the plain paths book nothing, and a thread booking K1 ledgers in a
loop never lets a live evaluation see a split pair."""

import json
import math
import os
import subprocess
import sys
import threading

import pytest
import torch

from image_analogies_tpu.telemetry import sentinel as j_sent
from image_analogies_tpu.telemetry import slo as j_slo
from image_analogies_tpu_torch import SynthConfig, kernels
from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
from image_analogies_tpu_torch.kernels import polish_stream as ps
from image_analogies_tpu_torch.telemetry import metrics as t_metrics
from image_analogies_tpu_torch.telemetry import sentinel as t_sent
from image_analogies_tpu_torch.telemetry import slo as t_slo
from torch_modes import set_modes  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def session_registry():
    """A fresh process-default registry for the test, restored after."""
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    yield reg
    t_metrics.set_registry(prev)


# ------------------------------------------------------------ test inputs
def counter(values):
    return {"kind": "counter", "help": "", "values": values}


def gauge(values):
    return {"kind": "gauge", "help": "", "values": values}


def level_tree(energies=(0.1, 0.2), em_children=2, unclosed=False):
    levels = []
    for i, e in enumerate(energies):
        levels.append({
            "name": "level", "t": float(i), "wall_ms": 10.0,
            "attrs": {"level": len(energies) - 1 - i, "em_iters": 2,
                      "nnf_energy": e},
            "children": [{"name": "em_iter", "t": None, "wall_ms": None,
                          "attrs": {}, "children": []}] * em_children,
        })
    run = {"name": "run", "t": 0.0, "wall_ms": None if unclosed else 30.0,
           "attrs": {}, "children": levels}
    return {"schema_version": 1, "t0": None, "spans": [run]}


def slo_metrics(ok=100, slow=0, failed=0, shed=0):
    """A serialized `ia_request_duration_ms` family built by the port's
    registry (the input both packages grade)."""
    reg = t_metrics.MetricsRegistry()
    h = reg.histogram("ia_request_duration_ms",
                      buckets=t_slo.REQUEST_DURATION_BUCKETS)
    hit = {"route": "/synthesize", "cache": "hit"}
    for _ in range(ok):
        h.observe(40.0, labels={**hit, "outcome": "ok"})
    for _ in range(slow):
        h.observe(50000.0, labels={**hit, "outcome": "ok"})
    for _ in range(failed):
        h.observe(100.0, labels={**hit, "outcome": "failed"})
    for _ in range(shed):
        h.observe(1.0, labels={**hit, "outcome": "shed"})
    return reg.to_dict()


SERVING_OK = {
    "ia_serve_requests_total": counter({"total": 10.0}),
    "ia_serve_admitted_total": counter({"total": 8.0}),
    "ia_serve_shed_total": counter({"total": 2.0}),
    "ia_serve_completed_total": counter({"total": 7.0}),
    "ia_serve_failed_total": counter({"total": 1.0}),
    "ia_serve_dispatches_total": counter({"total": 5.0}),
    "ia_serve_excache_hits_total": counter({'{kind="client"}': 4.0}),
    "ia_serve_excache_misses_total": counter({"total": 1.0}),
}

JOURNAL = {"appended": 5.0, "done": 3.0, "replayed": 1.0,
           "cancelled": 0.0, "pending": 1.0}


def journal(**over):
    vals = {**JOURNAL, **over}
    return {"ia_serve_journal": gauge(
        {f'{{field="{k}"}}': v for k, v in vals.items()}),
        "ia_serve_queue_depth": gauge({"value": 1.0})}


def video(cold=1.0, warm=3.0, booked=3.0, wsweeps=6.0, cold_eq=12.0,
          streams=1.0):
    return {
        "ia_video_frames_total": counter({'{mode="cold"}': cold,
                                          '{mode="warm"}': warm}),
        "ia_warm_start_frames_total": counter({"total": booked}),
        "ia_warm_start_sweeps_total": counter({
            '{mode="warm"}': wsweeps, '{mode="cold_equiv"}': cold_eq}),
        "ia_video_streams_total": counter({"total": streams}),
    }


def recovery(attempts, retries=None, degr=None, breaches=0.0, inj=None,
             invocations=None):
    m = {"ia_supervisor_attempts_total": counter({"total": attempts})}
    if retries:
        m["ia_retries_total"] = counter(retries)
    if degr:
        m["ia_degradations_total"] = counter(degr)
    if breaches:
        m["ia_watchdog_breaches_total"] = counter({"total": breaches})
    if inj:
        m["ia_fault_injections_total"] = counter(inj)
    if invocations:
        m["ia_supervisor_invocations_total"] = counter(
            {"total": invocations})
    if not attempts:
        del m["ia_supervisor_attempts_total"]
    return m


RAISE = '{action="raise",point="level"}'

# (check function name, arguments, the status both must give)
CASES = [
    ("check_energy_series", (level_tree(), None), "ok"),
    ("check_energy_series", (level_tree((0.1, 20.0)), None), "degraded"),
    ("check_energy_series", (level_tree((0.1, -1.0)), None), "violated"),
    ("check_energy_series",
     (None, {"ia_nnf_energy": gauge({'{level="0"}': math.inf})}),
     "violated"),
    ("check_energy_series", (None, {}), "skipped"),
    ("check_span_tree", (level_tree(),), "ok"),
    ("check_span_tree", (level_tree(unclosed=True),), "violated"),
    ("check_span_tree", (level_tree(em_children=1),), "violated"),
    ("check_span_tree", (None,), "skipped"),
    ("check_telemetry_overhead",
     ({"ia_telemetry_overhead_frac": gauge({"value": 0.01})},), "ok"),
    ("check_telemetry_overhead",
     ({"ia_telemetry_overhead_frac": gauge({"value": 0.01}),
       "ia_live_telemetry_overhead_frac": gauge({"value": 0.05})},),
     "degraded"),
    ("check_telemetry_overhead", ({},), "skipped"),
    ("check_straggler_skew",
     ({"ia_shard_imbalance_ratio": gauge(
         {'{axis="bands",level="0"}': 2.0,
          '{axis="bands",level="1"}': 1.1})},), "ok"),
    ("check_straggler_skew",
     ({"ia_shard_imbalance_ratio": gauge(
         {'{axis="bands",level="0"}': 2.0,
          '{axis="bands",level="1"}': 1.6})},), "degraded"),
    ("check_straggler_skew", ({},), "skipped"),
    ("check_recovery", ({},), "skipped"),
    ("check_recovery", (recovery(0.0, inj={RAISE: 1.0}),), "skipped"),
    ("check_recovery",
     (recovery(2.0, retries={'{reason="raise"}': 1.0},
               inj={RAISE: 1.0}),), "ok"),
    ("check_recovery",
     (recovery(2.0, retries={'{reason="raise"}': 1.0},
               degr={'{rung="stream->sequential"}': 1.0}),), "degraded"),
    ("check_recovery", (recovery(3.0),), "violated"),
    ("check_recovery",
     (recovery(2.0, retries={'{reason="raise"}': 1.0}, breaches=1.0),),
     "violated"),
    ("check_recovery",
     (recovery(4.0, retries={'{reason="raise"}': 1.0},
               invocations=3.0),), "ok"),
    ("check_serving", ({},), "skipped"),
    ("check_serving", (SERVING_OK,), "ok"),
    ("check_serving",
     ({**SERVING_OK, "ia_serve_queue_depth": gauge({"value": 3.0})},),
     "degraded"),
    ("check_serving",
     ({**SERVING_OK, "ia_serve_shed_total": counter({"total": 1.0})},),
     "violated"),
    ("check_serving",
     ({**SERVING_OK, "ia_excache_disk_hits_total": counter({"total": 1.0}),
       "ia_excache_disk_misses_total": counter({"total": 0.0}),
       "ia_excache_disk_errors_total": counter({"total": 1.0})},),
     "degraded"),
    ("check_serving_recovery", ({},), "skipped"),
    ("check_serving_recovery", (journal(),), "ok"),
    ("check_serving_recovery",
     ({**journal(), "ia_serve_journal_errors": gauge({"value": 2.0})},),
     "degraded"),
    ("check_serving_recovery", (journal(done=1.0),), "violated"),
    ("check_warm_start", ({},), "skipped"),
    ("check_warm_start", (video(),), "ok"),
    ("check_warm_start", (video(cold=2.0),), "degraded"),
    ("check_warm_start", (video(wsweeps=20.0),), "violated"),
    ("check_warm_start", (video(booked=2.0),), "violated"),
    ("check_slo", ({},), "skipped"),
    ("check_slo", (slo_metrics(),), "ok"),
    ("check_slo", (slo_metrics(failed=1, ok=150),), "degraded"),
    ("check_slo", (slo_metrics(slow=5),), "violated"),
    ("check_anomaly", ({},), "skipped"),
    ("check_anomaly",
     ({"ia_anomaly_status": gauge({'{watch="p99"}': 0.0,
                                   '{watch="miss_storm"}': -1.0})},), "ok"),
    ("check_anomaly",
     ({"ia_anomaly_status": gauge({'{watch="p99"}': 1.0})},), "degraded"),
    ("check_instrument_drift", (None,), "skipped"),
    ("check_instrument_drift", ({"kernel_sweep_ms_loop": 1.0},), "skipped"),
    ("check_instrument_drift",
     ({"kernel_sweep_ms_loop": 0.50, "kernel_sweep_ms_trace": 0.45},), "ok"),
    ("check_instrument_drift",
     ({"kernel_sweep_ms_loop": 0.90, "kernel_sweep_ms_trace": 0.45},),
     "degraded"),
    ("check_comms", ({},), "skipped"),
    ("check_comms",
     ({"ia_collectives_total": counter({'{axis="bands",kind="all_reduce"}':
                                        4.0}),
       "ia_collectives_expected_total": counter({'{axis="bands"}': 4.0})},),
     "ok"),
    ("check_comms",
     ({"ia_collectives_total": counter({'{axis="bands",kind="all_reduce"}':
                                        3.0})},), "violated"),
]


@pytest.mark.parametrize("name,args,status", CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}"
                              for i, c in enumerate(CASES)])
def test_check_equals_the_reference(name, args, status):
    got = getattr(t_sent, name)(*args)
    want = getattr(j_sent, name)(*args)
    assert got == want
    assert got["status"] == status


def test_constants_and_schema_are_the_reference():
    for k in ("HEALTH_FILE", "HEALTH_SCHEMA_VERSION", "ENERGY_MAX",
              "INSTRUMENT_DRIFT_FRAC", "OVERHEAD_BUDGET_FRAC",
              "IMBALANCE_RATIO_MAX", "SUSTAINED_SKEW_LEVELS",
              "PROVENANCES", "_OVERHEAD_GAUGES"):
        assert getattr(t_sent, k) == getattr(j_sent, k), k


@pytest.mark.parametrize("provenance", ["measured", "carried"])
@pytest.mark.parametrize("with_bench", [False, True])
def test_evaluate_health_equals_the_reference(provenance, with_bench):
    metrics = {**SERVING_OK, **video(), **journal(),
               "ia_telemetry_overhead_frac": gauge({"value": 0.01})}
    bench = ({"kernel_sweep_ms_loop": 0.5, "kernel_sweep_ms_trace": 0.45}
             if with_bench else None)
    kw = dict(spans=level_tree(), metrics=metrics, bench_record=bench,
              context="t", provenance=provenance)
    got = t_sent.evaluate_health(**kw)
    want = j_sent.evaluate_health(**kw)
    # The byte-ledger checks price the port's kernels (their details name
    # the port's models); with no ledger series both skip.
    dma = {"candidate_dma_model", "polish_dma_model", "coarse_dma_model"}

    def split(h):
        return ([c for c in h["checks"] if c["name"] not in dma],
                [(c["name"], c["status"]) for c in h["checks"]
                 if c["name"] in dma])

    assert split(got) == split(want)
    assert {k: v for k, v in got.items() if k != "checks"} == \
        {k: v for k, v in want.items() if k != "checks"}
    assert t_sent.render_health(got).splitlines()[0] == \
        j_sent.render_health(want).splitlines()[0]


# --------------------------------------------------------------- the SLO
@pytest.mark.parametrize("kw", [
    {}, {"ok": 0}, {"slow": 3}, {"failed": 2, "shed": 40},
    {"ok": 10, "shed": 200},
])
def test_evaluate_slo_equals_the_reference(kw):
    m = slo_metrics(**kw)
    for objectives in ("DEFAULT_OBJECTIVES", "ROUTE_OBJECTIVES"):
        got = t_slo.evaluate_slo(m, getattr(t_slo, objectives),
                                 window_s=30.0)
        want = j_slo.evaluate_slo(m, getattr(j_slo, objectives),
                                  window_s=30.0)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)


@pytest.mark.parametrize("q", [0.01, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_cell_equals_the_reference(q):
    cell = slo_metrics(ok=30, slow=2, failed=5)["ia_request_duration_ms"][
        "values"]
    for c in cell.values():
        assert t_slo.quantile_from_cell(c, q) == j_slo.quantile_from_cell(
            c, q)
    empty = {"count": 0, "sum": 0.0, "buckets": {}}
    assert t_slo.quantile_from_cell(empty, q) is None


def test_publish_slo_gauges_books_burn_rates():
    reg = t_metrics.MetricsRegistry()
    t_slo.publish_slo_gauges(t_slo.evaluate_slo(slo_metrics(slow=2)), reg)
    burn = reg.to_dict()["ia_slo_burn_rate"]["values"]
    assert burn['{objective="warm_p99_latency_ms"}'] == pytest.approx(
        2 / 102 / 0.01, abs=1e-4)


# ------------------------------------------------ the port's DMA ledgers
def book_k1(n=3, chan=4, rows=16, halo=2, dtype="bf16"):
    for _ in range(n):
        pt.book_launch(144 * 36 * 4, chan, rows, halo, dtype)


def book_k3(m=1000, d=68, itemsize=2, dtype="bf16"):
    ps.book_polish_rows(m, d, itemsize, dtype)


def book_coarse(n_rows=500, k=16):
    moved, useful = pt.coarse_dma_bytes_per_row(k, 4)
    with t_metrics.get_registry().unit():
        t_metrics.count_coarse_dma_bytes(n_rows * useful,
                                         n_rows * (moved - useful))
        t_metrics.count_coarse_dma_rows(n_rows, k, 4)


LEDGERS = [
    ("check_candidate_dma", "ia_candidate_dma_bytes_total", book_k1),
    ("check_polish_dma", "ia_polish_dma_bytes_total", book_k3),
    ("check_coarse_dma", "ia_coarse_dma_bytes_total", book_coarse),
]


@pytest.mark.parametrize("check,series,book", LEDGERS,
                         ids=[c[0] for c in LEDGERS])
def test_ledger_exact_then_one_byte_drift_violates(session_registry, check,
                                                   series, book):
    book()
    metrics = session_registry.to_dict()
    res = getattr(t_sent, check)(metrics)
    assert res["status"] == "ok" and res["expected"] == res["observed"]
    key = sorted(metrics[series]["values"])[0]
    metrics[series]["values"][key] += 1
    drifted = getattr(t_sent, check)(metrics)
    assert drifted["status"] == "violated"
    assert "drifted" in drifted["detail"]


@pytest.mark.parametrize("check,series,twin,labels", [
    ("check_candidate_dma", "ia_candidate_dma_bytes_total",
     "ia_candidate_dma_fetches_total", '{chan="4",dtype="bf16"}'),
    ("check_polish_dma", "ia_polish_dma_bytes_total",
     "ia_polish_dma_rows_total", '{dtype="bf16",itemsize="2"}'),
    ("check_coarse_dma", "ia_coarse_dma_bytes_total",
     "ia_coarse_dma_rows_total", '{itemsize="4"}'),
])
def test_ledger_unpriceable_labels_violate(check, series, twin, labels):
    metrics = {series: counter({'{kind="useful"}': 1.0}),
               twin: counter({labels: 2.0})}
    res = getattr(t_sent, check)(metrics)
    assert res["status"] == "violated"
    assert "unpriceable" in res["detail"]


@pytest.mark.parametrize("check,series", [
    ("check_candidate_dma", "ia_candidate_dma_bytes_total"),
    ("check_polish_dma", "ia_polish_dma_bytes_total"),
])
def test_bytes_without_their_twin_skip(check, series):
    res = getattr(t_sent, check)({series: counter(
        {'{dtype="bf16",kind="useful"}': 8.0})})
    assert res["status"] == "skipped"


def test_candidate_ledger_keeps_dtypes_apart(session_registry):
    book_k1(dtype="bf16")
    book_k1(n=2, dtype="int8")
    res = t_sent.check_candidate_dma(session_registry.to_dict())
    assert res["status"] == "ok"
    assert set(res["observed"]) == {"bf16", "int8"}
    assert res["observed"]["int8"]["moved"] == \
        res["observed"]["bf16"]["moved"] / 4 * 2 / 3


def test_k1_window_model_prices_what_the_kernel_loads():
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), True)
    halo = pt.halo_for(specs)
    rows = pt.sweep_plan(len(specs), halo)
    moved, useful = pt.candidate_window_bytes_per_fetch(len(specs), rows,
                                                        halo)
    assert moved == useful == 4 * (16 + 4) * 128 * 4
    assert pt.candidate_window_bytes_per_fetch(len(specs), rows, halo,
                                               "int8")[0] == moved // 4
    assert pt.coarse_dma_bytes_per_row(16) == (64, 64)
    assert pt.coarse_dma_bytes_per_row(5) == (32, 20)
    with pytest.raises(ValueError):
        pt.coarse_dma_bytes_per_row(0)


def test_live_reads_never_split_a_ledger_pair(session_registry):
    """One thread books K1 launches in a loop (bytes, then fetches, one
    unit each) while this one evaluates the sentinel on live reads: the
    candidate check is never violated."""
    stop = threading.Event()

    def booker():
        while not stop.is_set():
            pt.book_launch(9, 4, 16, 2, "bf16")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=booker)
    th.start()
    try:
        seen = set()
        for _ in range(400):
            res = t_sent.check_candidate_dma(session_registry.to_dict())
            seen.add(res["status"])
            assert res["status"] != "violated", res
    finally:
        stop.set()
        th.join()
        sys.setswitchinterval(old)
    assert "ok" in seen


# -------------------------------------- the bookings at the kernel sites
@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' kernel path on CPU tensors: the dispatch and contract
    checks accept them and the library call does nothing (the outputs are
    not read), so the bookings run as on the card."""

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    for mod in (kernels, pt, ps):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    for mod in (pt, ps):
        monkeypatch.setattr(mod, "library", lambda name: Lib())
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)


def sweep_args(n_f=None, size=128):
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), True)
    geom = pt.tile_geometry(size, size, specs)
    g = torch.Generator().manual_seed(0)
    img = [torch.rand(size, size, generator=g) for _ in range(2)]
    half = [torch.rand(size // 2, size // 2, generator=g) for _ in range(2)]
    a = pt.prepare_a_planes(img[0], img[1], half[0], half[1], specs)
    b = pt.prepare_b_planes(img[0], img[1], half[0], half[1], geom)
    cand = torch.zeros(geom.n_ty, geom.n_tx, pt.K_TOTAL, dtype=torch.int32)
    z = torch.zeros(geom.n_ty * 64, geom.n_tx * geom.tile_w,
                    dtype=torch.int32)
    d = torch.full(z.shape, float("inf"))
    args = [a, b, cand, cand, cand + 1, z, z, d]
    if n_f:
        args = [a] + [t[None].repeat(n_f, *([1] * t.ndim)).contiguous()
                      for t in args[1:]]
    kw = dict(specs=specs, geom=geom, ha=size, wa=size, coh_factor=1.0)
    return args, kw, geom


@pytest.mark.parametrize("n_f,budget", [(None, None), (3, None), (None, 8)])
def test_k1_wrapper_books_its_static_bound(session_registry, fake_launch,
                                           n_f, budget):
    args, kw, geom = sweep_args(n_f)
    pt.tile_sweep_kernel(*args, cand_budget=budget, **kw)
    pt.tile_sweep_kernel(*args, cand_budget=budget, **kw)
    m = session_registry.to_dict()
    rows = pt.sweep_plan(4, geom.halo)
    want = 2 * (n_f or 1) * geom.n_ty * geom.n_tx * (budget or 36) \
        * (64 // rows)
    assert m["ia_candidate_dma_fetches_total"]["values"] == {
        f'{{chan="4",dtype="bf16",halo="2",rows="{rows}"}}': float(want)}
    assert m["ia_kernel_launches_total"]["values"] == {
        '{kernel="tile_sweep"}': 2.0}
    res = t_sent.check_candidate_dma(m)
    assert res["status"] == "ok"
    assert res["observed"]["bf16"]["useful"] == want * 4 * (rows + 4) \
        * 128 * 4


def test_k3_wrapper_books_its_rows(session_registry, fake_launch):
    table = ps.prepare_polish_table(torch.rand(50, 68).to(torch.bfloat16))
    ps.gather_rows(table, torch.arange(40).reshape(4, 10), useful_width=68)
    q, _ = ps.quantize_rows(torch.rand(50, 68))
    ps.gather_rows(ps.prepare_polish_table(q), torch.arange(7),
                   useful_width=68, cand_dtype="int8")
    m = session_registry.to_dict()
    assert m["ia_polish_dma_rows_total"]["values"] == {
        '{d_useful="68",dtype="bf16",itemsize="2"}': 40.0,
        '{d_useful="68",dtype="int8",itemsize="1"}': 7.0}
    res = t_sent.check_polish_dma(m)
    assert res["status"] == "ok"
    assert res["observed"] == {
        "bf16": {"useful": 40 * 136.0, "moved": 40 * 256.0},
        "int8": {"useful": 7 * 72.0, "moved": 7 * 132.0}}


def test_int8_index_select_polish_books_on_the_card_path(session_registry,
                                                         monkeypatch):
    from image_analogies_tpu_torch.models import patchmatch as t_pm

    tab = torch.rand(30, 68)
    gf = t_pm._polish_gather_fn(tab, False, "int8", "sequential")
    gf(None, torch.arange(9))
    assert "ia_polish_dma_rows_total" not in session_registry.to_dict()
    monkeypatch.setattr(kernels, "on_cuda", lambda t: True)
    gf = t_pm._polish_gather_fn(tab, False, "int8", "sequential")
    gf(None, torch.arange(9))
    res = t_sent.check_polish_dma(session_registry.to_dict())
    assert res["status"] == "ok"
    assert res["observed"] == {"int8": {"useful": 9 * 72.0,
                                        "moved": 9 * 132.0}}


def test_prune_books_its_rows_on_the_card_path(session_registry,
                                               monkeypatch):
    g = torch.Generator().manual_seed(0)
    n_ty, n_tx, k = 2, 1, 16
    cand = torch.randint(-20, 20, (n_ty, n_tx, pt.K_TOTAL), generator=g,
                         dtype=torch.int32)
    valid = torch.ones_like(cand)
    proj_b = torch.rand(n_ty, n_tx, 4, k, generator=g)
    qy = torch.randint(0, 64, (n_ty, n_tx, 4), generator=g)
    proj_a = torch.rand(64 * 64, k, generator=g)
    args = (cand, cand, valid, proj_b, qy, qy, proj_a, 64, 64, 8)
    pt.prune_candidates(*args)
    assert "ia_coarse_dma_rows_total" not in session_registry.to_dict()
    monkeypatch.setattr(pt, "on_cuda", lambda t: True)
    pt.prune_candidates(*args)
    m = session_registry.to_dict()
    assert m["ia_coarse_dma_rows_total"]["values"] == {
        '{itemsize="4",k="16"}': float(n_ty * n_tx * pt.K_TOTAL * 4)}
    assert t_sent.check_coarse_dma(m)["status"] == "ok"


def test_plain_paths_book_no_ledger(session_registry):
    args, kw, _ = sweep_args()
    pt.tile_sweep(*args, **kw)
    table = ps.prepare_polish_table(torch.rand(20, 68))
    ps.gather_rows(table, torch.arange(5), useful_width=68)
    assert session_registry.to_dict() == {}
    health = t_sent.evaluate_health(metrics=session_registry.to_dict())
    by = {c["name"]: c["status"] for c in health["checks"]}
    assert by["candidate_dma_model"] == by["polish_dma_model"] == \
        by["coarse_dma_model"] == "skipped"


def test_compressed_tile_path_ledgers_exact(session_registry, fake_launch,
                                            monkeypatch, set_modes):
    """The compressed tile path (int8 planes, prune 16:8, stream polish)
    at 128^2 with the kernels' bookings on: all three ledgers exact, the
    K1 fetches at the prune's budget."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.utils.examples import super_resolution

    real_k1, real_k3 = pt.tile_sweep_kernel, ps.gather_rows_kernel

    def k1(*args, **kw):
        out = real_k1(*args, **kw)
        want = pt.tile_sweep_plain(*args, **{
            k: v for k, v in kw.items() if k not in ("cand_budget",
                                                     "general")})
        for o, w in zip(out, want):
            o.copy_(w)
        return out

    def k3(table, idx, **kw):
        out = real_k3(table, idx, **kw)
        out.copy_(ps.gather_rows_plain(table, idx))
        return out

    monkeypatch.setattr(pt, "tile_sweep_kernel", k1)
    monkeypatch.setattr(ps, "gather_rows_kernel", k3)
    set_modes(cand_dtype="int8", prune="16:8", polish="stream")
    a, ap, b = (torch.as_tensor(x) for x in super_resolution(128))
    cfg = SynthConfig(levels=2, em_iters=1, pm_iters=2, device="cpu")
    create_image_analogy(a, ap, b, cfg)
    m = session_registry.to_dict()
    health = t_sent.evaluate_health(metrics=m)
    by = {c["name"]: c for c in health["checks"]}
    for name in ("candidate_dma_model", "polish_dma_model",
                 "coarse_dma_model"):
        assert by[name]["status"] == "ok", by[name]
        assert by[name]["expected"] == by[name]["observed"]
    fetches = m["ia_candidate_dma_fetches_total"]["values"]
    (label,) = fetches
    assert 'dtype="int8"' in label
    # One tile level (128^2): 2 sweeps of 2 x 2 tiles x 8 slots x 4
    # strips of 16 rows.
    assert fetches[label] == 2 * 2 * 2 * 8 * 4


def test_health_record_passes_the_validator(tmp_path):
    health = t_sent.evaluate_health(spans=level_tree(), metrics=SERVING_OK)
    path = tmp_path / "health.json"
    t_sent.write_health(health, str(path))
    res = subprocess.run(
        [sys.executable, "tools/check_report.py", str(path)], cwd=ROOT,
        capture_output=True, text=True, timeout=60,
    )
    assert res.returncode == 0, res.stdout + res.stderr


# ----------------------------------------------------------- the K1 bench
def test_kernelbench_setup_evaluates_every_slot():
    from image_analogies_tpu_torch.utils import kernelbench

    cfg = SynthConfig(levels=2, device="cpu")
    _, _, meta = kernelbench.sweep_setup(cfg, 512, device="cpu")
    # 8 x 5 tiles: the last column's padding repeats edge offsets, which
    # its neighbour columns (the first by wrap-around) take on; tile
    # columns 1 and 2 evaluate every slot.
    valid = meta["args"][4]
    assert valid.shape == (8, 5, pt.K_TOTAL)
    assert bool((valid[:, 1:3] == 1).all())
    assert meta["slots"] == 40 * pt.K_TOTAL
    assert meta["valid_slots"] == int(valid.sum())
    moved, _ = pt.candidate_window_bytes_per_fetch(
        4, meta["strip_rows"], 2, "bf16")
    assert meta["window_bytes"] == meta["valid_slots"] * (64 // 16) * moved
    one_iter, s0, _ = kernelbench.sweep_setup(cfg, 128, device="cpu")
    oy, ox, d = one_iter(*s0)
    assert torch.isfinite(d).all()
    assert kernelbench.sweep_setup(cfg, 64, device="cpu") is None


def test_kernelbench_setup_under_the_prune(set_modes):
    from image_analogies_tpu_torch.utils import kernelbench

    set_modes(prune="16:8")
    _, _, meta = kernelbench.sweep_setup(SynthConfig(device="cpu"), 256,
                                         device="cpu")
    assert meta["prune"] == (16, 8)
    valid = meta["args"][4]
    assert bool((valid[..., 8:] == 0).all())
    assert meta["valid_slots"] == int(valid.sum()) <= 12 * 8


def test_kernelbench_timings_need_the_card():
    from image_analogies_tpu_torch.utils import kernelbench

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (kernelbench.sweep_time_ms,
               kernelbench.sweep_time_device_loop_ms,
               kernelbench.sweep_time_trace_ms):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(SynthConfig(), 128)

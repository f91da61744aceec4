"""The port's merged report and its device-trace reader on the CPU.

`utils/torch_trace.py` on a hand-written Chrome trace: `tlm_*` ranges
on the launching thread, kernels and a copy linked to their launches by
correlation id (one kernel, and one on a second stream overlapping it,
executing after the range that launched them closed), a device event
launched outside every range, and the device timeline's own annotations
(ignored): exact totals by op, by scope and by range, and the busy
union.  A trace of a CPU run has no device events.  `build_report` on a
traced CPU run of the port's CLI (--trace-dir D --profile D --health
--metrics-port 0) equals the reference's `build_report` on the same
directory (neither finds device events), the progress-stream
reconstruction too, and `tools/check_report.py` accepts the port's
report.json and health.json; `health` and `report` run on that
directory."""

import json
import os
import subprocess
import sys

import pytest
import torch

from image_analogies_tpu.telemetry import report as j_report
from image_analogies_tpu_torch import cli
from image_analogies_tpu_torch.telemetry import report as t_report
from image_analogies_tpu_torch.utils import torch_trace as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ a fixture trace
HOST = {"pid": 100, "tid": 1}
GPU = {"pid": 0, "tid": 7}


def _range(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            **HOST, "args": {}}


def _launch(corr, ts, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 3,
            **HOST, "args": {"correlation": corr}}


def _device(corr, name, ts, dur, cat="kernel", stream=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream,
            "args": {"correlation": corr, "device": 0, "stream": stream}}


FIXTURE = [
    _range("tlm_L0", 0, 100),
    _range("tlm_em0", 10, 50),
    _range("tlm_match", 20, 30),
    _range("tlm_L1", 200, 100),
    _range("tlm_render", 210, 40),
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 21, "dur": 2,
     **HOST, "args": {}},
    _launch(1, 25),
    _launch(6, 27),
    _launch(5, 30, name="cudaMemcpyAsync"),
    _launch(2, 55, name="cuLaunchKernel", cat="cuda_driver"),
    _launch(3, 220),
    _launch(4, 400),
    # k_a and k_f run after tlm_match (20-50) and tlm_em0 (10-60) closed,
    # k_f on a second stream overlapping k_a.
    _device(1, "k_a", 70, 40),
    _device(6, "k_f", 80, 10, stream=8),
    _device(5, "Memcpy HtoD (Pageable -> Device)", 60, 5,
            cat="gpu_memcpy"),
    _device(2, "k_b", 110, 20),
    _device(3, "k_c", 260, 30),
    _device(4, "k_d", 400, 10),
    # The device timeline's annotation: not used.
    {"ph": "X", "cat": "gpu_user_annotation", "name": "tlm_L0", "ts": 60,
     "dur": 70, **GPU, "args": {}},
    {"ph": "s", "cat": "ac2g", "name": "flow", "id": 1, "ts": 25, **HOST},
]


@pytest.fixture
def trace_dir(tmp_path):
    with open(tmp_path / tt.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": FIXTURE, "displayTimeUnit": "ms"}, f)
    return str(tmp_path)


def test_op_totals(trace_dir):
    assert tt.device_op_totals(trace_dir) == {"GPU 0": {
        "k_a": 40 / 1e3, "k_f": 10 / 1e3, "k_b": 20 / 1e3, "k_c": 30 / 1e3,
        "k_d": 10 / 1e3, "Memcpy HtoD (Pageable -> Device)": 5 / 1e3}}


def test_ops_attributed_by_their_launch(trace_dir):
    s = tt.summarize(tt.load_events(tt.find_trace(trace_dir)))
    assert s["scoped_ops"] == {
        "tlm_L0/tlm_em0/tlm_match/k_a": 40 / 1e3,
        "tlm_L0/tlm_em0/tlm_match/k_f": 10 / 1e3,
        "tlm_L0/tlm_em0/tlm_match/Memcpy HtoD (Pageable -> Device)":
            5 / 1e3,
        "tlm_L0/tlm_em0/k_b": 20 / 1e3,
        "tlm_L1/tlm_render/k_c": 30 / 1e3,
        "k_d": 10 / 1e3,
    }


def test_scope_totals_and_busy_union(trace_dir):
    by_range = tt.device_scope_totals(trace_dir)
    assert by_range == pytest.approx({
        "tlm_L0": 0.075, "tlm_em0": 0.075, "tlm_match": 0.055,
        "tlm_L1": 0.030, "tlm_render": 0.030}, rel=1e-12, abs=0)
    assert tt.device_scope_totals(trace_dir, t_report.LEVEL_TAG_RE) == \
        pytest.approx({"0": 0.075, "1": 0.030}, rel=1e-12, abs=0)
    assert tt.device_scope_totals(trace_dir, t_report.PHASE_TAG_RE) == \
        pytest.approx({"match": 0.055, "render": 0.030}, rel=1e-12, abs=0)
    # [60, 65], [70, 130] (k_a, k_f and k_b merged), [260, 290],
    # [400, 410] microseconds.
    assert tt.device_busy_ms(trace_dir) == 105 / 1e3


def test_report_joins_the_fixture(trace_dir):
    spans = {"schema_version": 1, "t0": None, "spans": [{
        "name": "run", "t": 0.0, "wall_ms": 9.0, "attrs": {},
        "children": [
            {"name": "prologue", "t": 0.0, "wall_ms": 1.0, "attrs": {}},
            {"name": "level", "t": 1.0, "wall_ms": 3.0,
             "attrs": {"level": 1, "shape": [8, 8], "nnf_energy": 0.1}},
            {"name": "level", "t": 4.0, "wall_ms": 5.0,
             "attrs": {"level": 0, "shape": [16, 16], "nnf_energy": 0.2},
             "children": [{"name": "em_iter", "t": None, "wall_ms": None,
                           "attrs": {"em": 0}}]},
        ]}]}
    rep = t_report.build_report(trace_dir=trace_dir, spans=spans)
    assert [(lv["level"], lv["device_busy_ms"]) for lv in rep["levels"]] \
        == [(1, 0.03), (0, 0.075)]
    assert rep["levels"][1]["em_device_busy_ms"] == {"0": 0.075}
    assert rep["phases"] == {"match": 0.055, "render": 0.03}
    assert rep["device"]["planes"] == ["GPU 0"]
    assert rep["device"]["total_busy_ms"] == 0.105
    assert rep["device"]["top_ops"][0] == ("k_a", 0.04)
    assert rep["prologue"] == {"wall_ms": 1.0, "device_busy_ms": None}


def test_cpu_trace_has_no_device_fields(tmp_path):
    events = [e for e in FIXTURE if e.get("cat") not in tt.DEVICE_CATS]
    with open(tmp_path / tt.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert tt.device_op_totals(str(tmp_path)) == {}
    assert tt.device_busy_ms(str(tmp_path)) is None
    assert tt.device_scope_totals(str(tmp_path)) == {}
    assert tt.device_busy_ms(str(tmp_path / "absent")) is None


def test_truncated_trace_degrades_the_device_side(tmp_path):
    (tmp_path / tt.TRACE_FILE).write_text('{"traceEvents": [{"ph": "X"')
    with pytest.raises(ValueError):
        tt.device_op_totals(str(tmp_path))
    rep = t_report.build_report(trace_dir=str(tmp_path), spans={
        "spans": [{"name": "level", "wall_ms": 1.0, "attrs": {"level": 0}}]})
    assert rep["device"]["total_busy_ms"] is None
    assert "error" in rep["device"]
    assert rep["levels"][0]["device_busy_ms"] is None


# ----------------------------------------- a traced CPU run of the CLI
@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("traced"))
    assert cli.main(["examples", "--out", d, "--size", "64"]) == 0
    td, prog = os.path.join(d, "td"), os.path.join(d, "run.jsonl")
    fam = os.path.join(d, "texture_by_numbers")
    rc = cli.main([
        "synth", "--a", f"{fam}_A.png", "--ap", f"{fam}_Ap.png", "--b",
        f"{fam}_B.png", "--out", os.path.join(d, "bp.png"), "--device",
        "cpu", "--levels", "2", "--em-iters", "2", "--pm-iters", "2",
        "--trace-dir", td, "--profile", td, "--progress", prog, "--health",
        "--metrics-port", "0",
    ])
    assert rc == 0
    return td, prog


def test_traced_cli_writes_every_artifact(traced_run):
    td, _ = traced_run
    assert {"host_spans.json", "metrics.json", "metrics.prom",
            "flight.json", "health.json", "live.json",
            tt.TRACE_FILE} <= set(os.listdir(td))
    health = json.load(open(os.path.join(td, "health.json")))
    assert health["context"] == "synth" and health["verdict"] == "ok"
    by = {c["name"]: c["status"] for c in health["checks"]}
    assert by["span_tree"] == by["energy_series"] == "ok"


def test_report_equals_the_reference_on_the_run(traced_run):
    td, _ = traced_run
    got = t_report.build_report(trace_dir=td)
    want = j_report.build_report(trace_dir=td)
    assert got == want
    assert got["device"]["total_busy_ms"] is None
    assert [lv["level"] for lv in got["levels"]] == [1, 0]
    assert t_report.render_table(got) == j_report.render_table(want)


def test_progress_reconstruction_equals_the_reference(traced_run):
    _, prog = traced_run
    assert t_report.spans_from_progress(prog) == \
        j_report.spans_from_progress(prog)
    got = t_report.build_report(progress_path=prog)
    assert got == j_report.build_report(progress_path=prog)
    assert not got["host_spans"]


@pytest.mark.parametrize("sub,record", [("report", "report.json"),
                                        ("health", "health.json")])
def test_subcommand_record_passes_the_validator(traced_run, sub, record,
                                                capsys):
    td, _ = traced_run
    assert cli.main([sub, "--trace-dir", td, "--format", "json"]) == 0
    res = subprocess.run(
        [sys.executable, "tools/check_report.py",
         os.path.join(td, record)], cwd=ROOT, capture_output=True,
        text=True, timeout=60,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_health_subcommand_exits_1_on_violated(tmp_path):
    (tmp_path / "metrics.json").write_text(json.dumps({
        "ia_candidate_dma_bytes_total": {"kind": "counter", "help": "",
                                         "values": {'{kind="useful"}': 1}},
        "ia_candidate_dma_fetches_total": {"kind": "counter", "help": "",
                                           "values": {"total": 1}},
    }))
    assert cli.main(["health", "--trace-dir", str(tmp_path)]) == 1
    with pytest.raises(SystemExit, match="no telemetry artifacts"):
        cli.main(["health", "--trace-dir", str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="no host timing source"):
        cli.main(["report", "--trace-dir", str(tmp_path / "none")])

"""The telemetry archive and black box of the port
(`telemetry/archive.py`, the daemon's `--archive-dir` hooks, the
`archive_crash` fault point, `history` and `incident`) against the JAX
package's, on the CPU:

  - the reference's unit classes (tests/test_archive.py: segments and
    sealing, resume state, the incident store, the access log's shift
    chain, ring generations, `history`, the fault grammar), run against
    the port's modules;
  - each package reads the other's archive: the records and
    `load_resume_state` equal whichever package wrote them, and a port
    daemon resumes the baseline a JAX archive holds;
  - `archive_crash` in a process of its own: it exits 137 with half a
    line on disk, which reload skips and counts;
  - a port daemon with an archive and a baseline no request can meet:
    one incident bundle with every section (later ticks suppressed), a
    final snapshot at drain, a restart resuming the baseline at a later
    generation, `history` showing both boots and `incident` rendering
    the bundle.

Frames are 16^2, two levels, one EM step; torch runs on one intra-op
thread."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import test_archive as ref  # noqa: E402
from image_analogies_tpu.telemetry import archive as j_arch  # noqa: E402
from image_analogies_tpu_torch import cli as t_cli  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving.daemon import SynthDaemon  # noqa: E402
from image_analogies_tpu_torch.telemetry import archive as t_arch  # noqa: E402
from image_analogies_tpu_torch.telemetry.anomaly import (  # noqa: E402
    AnomalyConfig,
)
from image_analogies_tpu_torch.telemetry.flight import (  # noqa: E402
    FlightRecorder,
)
from image_analogies_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.spans import Tracer  # noqa: E402
from test_torch_serving import _SERVE_CFG, _body, _post  # noqa: E402
from torch_ref_swap import swap  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

# The sections a bundle must carry (tools/archive_drill.py's list).
BUNDLE_KEYS = ("id", "ts", "trigger", "flight", "access_tail", "obs_window",
               "slo", "anomaly", "serving", "fingerprint")


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    swap(monkeypatch, ref)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_names_are_the_ports():
    assert ref.TelemetryArchive is t_arch.TelemetryArchive
    assert ref.load_resume_state is t_arch.load_resume_state


# ------------------------------------- the reference's unit classes
class TestTelemetryArchive(ref.TestTelemetryArchive):
    pass


class TestLoadResumeState(ref.TestLoadResumeState):
    pass


class TestIncidentStore(ref.TestIncidentStore):
    pass


class TestAccessLogShiftChain(ref.TestAccessLogShiftChain):
    pass


class TestTimeSeriesGeneration(ref.TestTimeSeriesGeneration):
    pass


class TestHistoryCli(ref.TestHistoryCli):
    @pytest.fixture(autouse=True)
    def _port_cli(self, monkeypatch):
        import image_analogies_tpu.cli as j_cli

        monkeypatch.setattr(j_cli, "cmd_history", t_cli.cmd_history)


class TestArchiveFaultGrammar(ref.TestArchiveFaultGrammar):
    pass


# ------------------------------------------------ cross-package reads
def _write(mod, d):
    """Two boots, snapshots with rising generations, an incident note."""
    for boot, gens in enumerate(((0, 1), (2, 3))):
        arch = mod.TelemetryArchive(str(d))
        for g in gens:
            arch.append("snapshot", ref._snapshot_payload(
                gen=g, baseline=40.0 + boot, p99=10.0 + g))
        arch.append("incident", {"id": f"inc-{boot}",
                                 "trigger": {"kind": "anomaly"}})
        arch.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_archive(tmp_path, writer):
    _write(j_arch if writer == "jax" else t_arch, tmp_path)
    assert list(t_arch.read_archive_entries(str(tmp_path))) == \
        list(j_arch.read_archive_entries(str(tmp_path)))
    got = t_arch.load_resume_state(str(tmp_path))
    assert got == j_arch.load_resume_state(str(tmp_path))
    assert (got["boots"], got["generation"], got["baseline_p99_ms"],
            got["incidents"]) == (2, 3, 41.0, 2)


def test_port_daemon_resumes_a_jax_archive(tmp_path):
    _write(j_arch, tmp_path)
    a = np.zeros((16, 16, 3), np.float32)
    d = SynthDaemon(a, a, SynthConfig(device="cpu", **_SERVE_CFG),
                    registry=MetricsRegistry(), obs_interval_s=60.0,
                    archive_dir=str(tmp_path)).start()
    try:
        with urllib.request.urlopen(d.url + "/archive") as r:
            snap = json.loads(r.read())
    finally:
        d.stop()
    assert snap["anomaly_baseline_p99_ms"] == 41.0
    assert snap["obs_generation"] == 4
    assert snap["resumed"]["boots"] == 2


_CRASH = ("import sys; from image_analogies_tpu_torch.telemetry.archive "
          "import TelemetryArchive; a = TelemetryArchive(sys.argv[1]); "
          "[a.append('snapshot', {'obs_generation': i, "
          "'anomaly_baseline_p99_ms': 50.0}) for i in range(5)]")


def test_archive_crash_leaves_a_torn_tail_reload_skips(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _CRASH, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT,
             "IA_FAULT_PLAN": "archive_crash:3:fail"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 137, res.stderr
    with open(t_arch.archive_path(str(tmp_path)), "rb") as f:
        assert not f.read().endswith(b"\n")
    state = t_arch.load_resume_state(str(tmp_path))
    assert (state["records"], state["skipped_lines"]) == (3, 1)
    assert state["baseline_p99_ms"] == 50.0 and state["generation"] == 1


# ---------------------------------------------- the daemon, end to end
def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def archive_scenario(tmp_path_factory):
    """Boot 1: a baseline of 0.001 ms, archive and observatory ticks at
    0.1 s, two requests; the latency watch fires and the black box
    captures.  Drained.  Boot 2 on the same archive, no baseline: one
    request, then drained."""
    arch = str(tmp_path_factory.mktemp("archive"))
    rng = np.random.default_rng(8)
    a, ap, f = (rng.random((16, 16, 3)).astype(np.float32)
                for _ in range(3))
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    out = {}

    def boot(baseline):
        reg = MetricsRegistry()
        prev = set_registry(reg)
        tracer = Tracer(registry=reg)
        flight = FlightRecorder(tracer, reg, os.path.join(arch, "f.json"),
                                capacity=256)
        tracer.add_observer(flight.observe)
        d = SynthDaemon(
            a, ap, cfg, registry=reg, tracer=tracer, flight=flight,
            max_batch=1, max_wait_ms=5.0,
            obs_interval_s=0.1, archive_dir=arch, archive_interval_s=0.1,
            anomaly_config=AnomalyConfig(baseline_p99_ms=baseline),
        ).start()
        return d, prev

    d, prev = boot(0.001)
    try:
        for _ in range(2):
            assert _post(d.url, _body(f))[0] == 200
        t0 = time.monotonic()
        while _get(d.url + "/incidents")["captured"] < 1:
            assert time.monotonic() - t0 < 30, "no incident captured"
            time.sleep(0.05)
        time.sleep(0.6)  # later firing ticks: rate-limited
        out["index"] = _get(d.url + "/incidents")
        inc = out["index"]["incidents"][0]["id"]
        out["bundle"] = _get(f"{d.url}/incidents?id={inc}")
        out["archive1"] = _get(d.url + "/archive")
        d.begin_drain()
        assert d.drained.wait(30)
    finally:
        d.stop()
        set_registry(prev)
    d, prev = boot(None)
    try:
        out["archive2"] = _get(d.url + "/archive")
        assert _post(d.url, _body(f))[0] == 200
        time.sleep(0.35)
        out["slo2"] = _get(d.url + "/slo")
        d.begin_drain()
        assert d.drained.wait(30)
    finally:
        d.stop()
        set_registry(prev)
    out["arch"] = arch
    return out


class TestArchiveDaemon:
    def test_one_bundle_rate_limited(self, archive_scenario):
        idx = archive_scenario["index"]
        assert idx["captured"] == 1 and idx["suppressed"] >= 1
        assert idx["incidents"][0]["trigger_kind"] == "anomaly"

    def test_bundle_carries_every_section(self, archive_scenario):
        b = archive_scenario["bundle"]
        assert [k for k in BUNDLE_KEYS if b.get(k) is None] == []
        assert "latency_p99" in b["trigger"]["watches"]
        assert b["fingerprint"]["backend"] == "cpu"
        assert b["flight"]["flushed_on"] == "incident"
        assert b["access_tail"] and b["serving"]["cache"]["resident"] == 1

    def test_restart_resumes_baseline_at_a_later_generation(
        self, archive_scenario
    ):
        a1, a2 = archive_scenario["archive1"], archive_scenario["archive2"]
        assert a1["anomaly_baseline_p99_ms"] == 0.001
        resumed = a2["resumed"]
        assert a2["anomaly_baseline_p99_ms"] == 0.001
        assert resumed["boots"] == 1 and resumed["incidents"] >= 1
        assert a2["obs_generation"] > resumed["generation"]
        watch = next(w for w in archive_scenario["slo2"]["anomalies"][
            "watches"] if w["watch"] == "latency_p99")
        assert watch["status"] != "no_data"

    def test_history_and_incident_render(self, archive_scenario,
                                         capsys):
        arch = archive_scenario["arch"]
        assert t_cli.main(["history", "--archive-dir", arch,
                           "--format", "json"]) == 0
        hist = json.loads(capsys.readouterr().out)
        assert len(hist["boots"]) == 2
        assert all(b["final"] for b in hist["boots"])
        inc = archive_scenario["index"]["incidents"][0]["id"]
        assert t_cli.main(["incident", inc, "--archive-dir", arch]) == 0
        text = capsys.readouterr().out
        assert f"incident {inc}" in text and "trigger=anomaly" in text

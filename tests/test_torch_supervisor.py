"""Supervised execution in the port, on the CPU: the fault plan's grammar,
firing, disarming, the abort token and the interruptible hang (the cases
of tests/test_supervisor.py, against the port's `runtime.faults`), and
the supervisor's heal paths (an injected raise, kernel and transfer
faults, a truncated checkpoint, a watchdog breach, the give-up with a
validated flight dump, the ladder stepping down and healing), each
healed B' bit-equal to the port's unfaulted run; the fault points of
the batch and video runners."""

import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from check_report import validate_flight  # noqa: E402

from image_analogies_tpu_torch import SynthConfig, create_image_analogy  # noqa: E402
from image_analogies_tpu_torch import synthesize_batch, synthesize_video  # noqa: E402
from image_analogies_tpu_torch.models import patchmatch as t_pm  # noqa: E402
from image_analogies_tpu_torch.runtime import faults, supervisor  # noqa: E402
from image_analogies_tpu_torch.runtime.faults import (  # noqa: E402
    FaultPlan,
    InjectedFault,
    InjectedTransferError,
    LevelAborted,
)
from image_analogies_tpu_torch.runtime.supervisor import (  # noqa: E402
    AbortToken,
    SupervisorGaveUp,
)
from image_analogies_tpu_torch.telemetry import MetricsRegistry, Tracer  # noqa: E402
from image_analogies_tpu_torch.telemetry.flight import FlightRecorder  # noqa: E402
from image_analogies_tpu_torch.telemetry.metrics import set_registry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_modes(monkeypatch):
    """No armed plan and the polish mode restored after every test."""
    monkeypatch.setattr(t_pm, "_POLISH_MODE", t_pm._POLISH_MODE)
    yield
    faults.set_fault_plan(None)


# ------------------------------------------------------------ fault plan
class TestFaultPlan:
    def test_parse_grammar(self):
        plan = FaultPlan.parse(
            "level:2:raise, level:1:hang:30; ckpt:1:truncate,"
            "xfer:0:fail,kernel:0:raise:3"
        )
        assert [(e.point, e.key, e.action) for e in plan.entries] == [
            ("level", 2, "raise"), ("level", 1, "hang"),
            ("ckpt", 1, "truncate"), ("xfer", 0, "fail"),
            ("kernel", 0, "raise"),
        ]
        assert plan.entries[1].arg == 30.0
        assert plan.entries[4].remaining == 3

    def test_parse_empty_is_none(self):
        assert FaultPlan.parse(None) is None
        assert FaultPlan.parse("") is None
        assert FaultPlan.parse("   ") is None

    @pytest.mark.parametrize("bad", [
        "level:2",                 # missing action
        "nowhere:0:raise",         # unknown point
        "level:0:explode",         # unknown action
        "level:x:raise",           # non-integer key
        "level:0:raise:zero",      # non-integer count
        "level:0:raise:0",         # count < 1
        "level:0:truncate",        # truncate off the ckpt point
        "level:0:hang:soon",       # non-numeric seconds
        "serve_crash:0:raise",     # a serving point's action is fail
        "serve_hang:0:fail",       # ... or hang, for serve_hang
        "archive_crash:0:raise",   # ... or fail, for archive_crash
    ])
    def test_parse_rejects_malformed(self, bad):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)

    def test_match_disarms(self):
        plan = FaultPlan.parse("level:1:raise:2")
        assert plan.match("level", 0) is None
        assert plan.match("level", 1) is not None
        assert plan.match("level", 1) is not None
        assert plan.match("level", 1) is None
        assert plan.armed() == []

    def test_env_plan_resolved_once(self, monkeypatch):
        monkeypatch.setenv("IA_FAULT_PLAN", "xfer:0:fail")
        monkeypatch.setattr(faults, "_PLAN_RESOLVED", False)
        plan = faults.resolve_fault_plan()
        assert plan.armed() == [("xfer", 0, "fail")]


class TestFire:
    def test_unarmed_fast_path(self):
        faults.set_fault_plan(None)
        assert faults.fire("level", 0) is None

    def test_raise_fires_once_and_counts(self):
        reg = MetricsRegistry()
        prev = set_registry(reg)
        try:
            faults.set_fault_plan("level:1:raise")
            with pytest.raises(InjectedFault):
                faults.fire("level", 1)
            assert faults.fire("level", 1) is None
        finally:
            set_registry(prev)
        vals = reg.counter("ia_fault_injections_total", "")._values
        assert vals == {(("action", "raise"), ("point", "level")): 1.0}

    def test_fail_raises_transfer_error(self):
        faults.set_fault_plan("xfer:0:fail")
        with pytest.raises(InjectedTransferError):
            faults.fire("xfer", 0)

    def test_truncate_returned_to_caller(self):
        faults.set_fault_plan("ckpt:1:truncate")
        assert faults.fire("ckpt", 1) == "truncate"

    def test_abort_token_raises_at_level_point(self):
        token = AbortToken()
        faults.set_abort_token(token)
        try:
            faults.set_fault_plan(None)
            assert faults.fire("level", 0) is None
            token.set("watchdog")
            with pytest.raises(LevelAborted):
                faults.fire("level", 0)
            assert faults.fire("ckpt", 0) is None
        finally:
            faults.set_abort_token(None)

    def test_hang_interrupted_by_abort(self):
        token = AbortToken()
        faults.set_abort_token(token)
        try:
            faults.set_fault_plan("level:0:hang:30")
            token.set("watchdog")
            t0 = time.perf_counter()
            with pytest.raises(LevelAborted):
                faults.fire("level", 0)
            assert time.perf_counter() - t0 < 5.0
        finally:
            faults.set_abort_token(None)


# -------------------------------------------------------- e2e supervised
def _inputs(n=32):
    rng = np.random.default_rng(0)
    a = rng.random((n, n)).astype(np.float32)
    ap = np.clip(a * 0.5 + 0.2, 0, 1).astype(np.float32)
    b = rng.random((n, n)).astype(np.float32)
    return a, ap, b


# tests/test_supervisor.py's knobs (levels 3 clamp to 2 at 32^2).
_E2E_CFG = dict(levels=3, matcher="patchmatch", em_iters=2, pm_iters=3,
                device="cpu")


@pytest.fixture(scope="module")
def oracle():
    a, ap, b = _inputs()
    bp = create_image_analogy(a, ap, b, SynthConfig(**_E2E_CFG)).numpy()
    return a, ap, b, bp


def _supervised(oracle, plan, **kw):
    """One supervised run against an armed plan: (result | None,
    give-up error | None, registry, tracer, flight path, ckpt dir)."""
    a, ap, b, _ = oracle
    ckpt = tempfile.mkdtemp(prefix="ia_sup_test_ckpt_")
    flight_dir = tempfile.mkdtemp(prefix="ia_sup_test_flight_")
    cfg = SynthConfig(**_E2E_CFG, save_level_artifacts=ckpt)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    tracer = Tracer(registry=reg)
    rec = FlightRecorder(tracer, reg, os.path.join(flight_dir, "flight.json"))
    rec.install()
    tracer.flight_recorder = rec
    faults.set_fault_plan(plan)
    out = err = None
    try:
        out = supervisor.supervise(
            lambda resume: create_image_analogy(
                a, ap, b, cfg, progress=tracer, resume_from=resume),
            ckpt_dir=ckpt, tracer=tracer, backoff_s=0.0, **kw,
        )
    except SupervisorGaveUp as e:
        err = e
    finally:
        faults.set_fault_plan(None)
        rec.uninstall()
        set_registry(prev)
    return (out, err, reg, tracer, os.path.join(flight_dir, "flight.json"),
            ckpt)


def _counter(reg, name):
    return dict(reg.counter(name, "")._values)


class TestSupervisedHeal:
    def test_injected_raise_heals_bit_identical(self, oracle):
        out, err, reg, tracer, _, ckpt = _supervised(oracle, "level:0:raise")
        assert err is None
        np.testing.assert_array_equal(out.numpy(), oracle[3])
        retries = _counter(reg, "ia_retries_total")
        assert sum(retries.values()) == 1
        ((labels, _),) = retries.items()
        assert dict(labels)["reason"] == "injected"
        # Level 1 was checkpointed before the fault: the retry resumed.
        assert "level_1.npz" in os.listdir(ckpt)
        assert len(tracer.find("resume")) == 1
        assert _counter(reg, "ia_supervisor_attempts_total") == {(): 2.0}

    @pytest.mark.parametrize("plan,reason", [
        ("kernel:0:raise", "injected"),
        ("xfer:0:fail", "transfer"),
    ])
    def test_kernel_and_transfer_faults_heal(self, oracle, plan, reason):
        out, err, reg, _, _, _ = _supervised(oracle, plan)
        assert err is None
        np.testing.assert_array_equal(out.numpy(), oracle[3])
        ((labels, _),) = _counter(reg, "ia_retries_total").items()
        assert dict(labels)["reason"] == reason

    def test_truncated_checkpoint_healed_by_resume(self, oracle):
        """ckpt:truncate cuts level 1's artifact after its rename; the
        retry's loader skips it (as the reference's does) and recomputes
        from scratch, bit-identically."""
        out, err, _, tracer, _, ckpt = _supervised(
            oracle, "ckpt:1:truncate,level:0:raise")
        assert err is None
        np.testing.assert_array_equal(out.numpy(), oracle[3])
        # The truncated artifact gave no resume point.
        assert tracer.find("resume") == []

    def test_truncated_artifact_is_skipped_by_the_loader(self, oracle,
                                                         tmp_path, caplog):
        """The partial file itself: the reference's loader skips it with a
        warning and the run starts over."""
        a, ap, b, _ = oracle
        ckpt = str(tmp_path / "ck")
        cfg = SynthConfig(**_E2E_CFG, save_level_artifacts=ckpt)
        faults.set_fault_plan("ckpt:0:truncate")
        create_image_analogy(a, ap, b, cfg)
        faults.set_fault_plan(None)
        size = os.path.getsize(os.path.join(ckpt, "level_0.npz"))
        assert size < os.path.getsize(os.path.join(ckpt, "level_1.npz"))
        out = create_image_analogy(a, ap, b, SynthConfig(**_E2E_CFG),
                                   resume_from=ckpt)
        assert "unreadable artifact level_0.npz" in caplog.text
        np.testing.assert_array_equal(out.numpy(), oracle[3])

    def test_watchdog_breach_heals(self, oracle):
        out, err, reg, _, flight_path, _ = _supervised(
            oracle, "level:0:hang:60",
            static_deadline_s=2.0, min_deadline_s=0.2, watchdog_slack=2.0,
        )
        assert err is None
        np.testing.assert_array_equal(out.numpy(), oracle[3])
        assert sum(_counter(reg, "ia_watchdog_breaches_total").values()) >= 1
        assert any(dict(k)["reason"] == "watchdog"
                   for k in _counter(reg, "ia_retries_total"))
        with open(flight_path) as f:
            dump = json.load(f)
        assert dump["flushed_on"] == "watchdog"
        assert validate_flight(dump) == []

    def test_give_up_leaves_validated_dump(self, oracle):
        out, err, _, _, flight_path, _ = _supervised(
            oracle, "level:1:raise:99", max_retries=0, ladder=[])
        assert out is None and err is not None
        assert isinstance(err.__cause__, InjectedFault)
        with open(flight_path) as f:
            dump = json.load(f)
        assert dump["flushed_on"] == "violation"
        assert validate_flight(dump) == []

    def test_ladder_degrades_then_heals(self, oracle):
        """Under the streamed polish the first rung is stream ->
        sequential (bit-safe); persistent failures step it, the run heals
        bit-identically, and the step is recorded."""
        t_pm.set_polish_mode("stream")
        out, err, reg, tracer, _, _ = _supervised(
            oracle, "level:0:raise:3", max_retries=1)
        assert err is None
        np.testing.assert_array_equal(out.numpy(), oracle[3])
        assert t_pm._POLISH_MODE == "sequential"
        assert _counter(reg, "ia_degradations_total") == {
            (("from", "stream"), ("to", "sequential")): 1.0}
        (mark,) = tracer.find("degradation")
        assert mark.attrs["rung"] == "polish_stream_to_sequential"

    def test_default_mode_has_no_rung(self):
        """The port's ladder: the reference's first three rungs; none
        applies in the default modes (the packed-layout rung has no
        counterpart)."""
        names = [r.name for r in supervisor.default_ladder()]
        assert names == ["polish_stream_to_sequential", "cand_int8_to_bf16",
                         "cand_pruned_to_full"]
        assert not any(r.applies() for r in supervisor.default_ladder())


class TestRetryResumeSource:
    def test_retry_falls_back_to_initial_resume_until_ckpt_exists(
            self, tmp_path):
        ckpt = str(tmp_path / "ck")
        calls = []

        def attempt(resume):
            calls.append(resume)
            if len(calls) == 1:
                raise RuntimeError("fail before any checkpoint")
            if len(calls) == 2:
                os.makedirs(ckpt, exist_ok=True)
                np.savez(os.path.join(ckpt, "level_1.npz"), x=1)
                raise RuntimeError("fail after checkpointing")
            return "done"

        out = supervisor.supervise(
            attempt, ckpt_dir=ckpt, initial_resume="user_dir",
            backoff_s=0.0, max_retries=5, ladder=[],
        )
        assert out == "done"
        assert calls == ["user_dir", "user_dir", ckpt]


@pytest.mark.parametrize("runner", ["batch", "video"])
@pytest.mark.parametrize("plan", ["level:0:raise", "kernel:1:raise",
                                  "xfer:0:fail"])
def test_frame_runners_fire_the_fault_points(runner, plan):
    """The batch and video runners carry the same points; a supervised
    retry of either heals to the unfaulted frames."""
    a, ap, b = _inputs(32)
    frames = np.stack([b, b[::-1].copy()])
    cfg = dict(levels=2, matcher="patchmatch", em_iters=1, pm_iters=2,
               device="cpu")

    def run(save=None, resume=None):
        c = SynthConfig(**cfg, save_level_artifacts=save)
        if runner == "batch":
            return synthesize_batch(a, ap, frames, c, resume_from=resume)
        return synthesize_video(a, ap, frames, c, resume_from=resume)

    want = run().numpy()
    faults.set_fault_plan(plan)
    with pytest.raises(InjectedFault):
        run()
    faults.set_fault_plan(plan)
    with tempfile.TemporaryDirectory() as ckpt:
        out = supervisor.supervise(
            lambda resume: run(save=ckpt, resume=resume), ckpt_dir=ckpt,
            backoff_s=0.0, ladder=[])
    np.testing.assert_array_equal(out.numpy(), want)

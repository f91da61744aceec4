"""Serving crash resilience of the port, on the CPU: the reference's
cases (tests/test_resilience.py) against the port's modules (the
journal's torn-line scan, rotation, the counted-not-raised diskfull
contract, the takeover pid lock; deadline parsing and pricing; the
DispatchDeadline guard; the observed-warmup drift fix; the
`check_serving_recovery` sentinel; drain -> 503, a pending request
surviving a restart and replayed bit-identically by the takeover), a
video session's state crossing a drain and a takeover, the
`serve_hang` and `serve_evict` fault points on a live daemon, the two
packages reading each other's `journal.jsonl` and
`warmup.observed.json`, and three behaviours where the port departs
from the reference after the card showed them: the journal's rewrites
stay linear past `max_bytes`, admission counts requests still in their
journal append (and holds its ledger under thread stress), and a
deadline shed carries a Retry-After."""

import base64
import hashlib
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.runtime.faults import set_fault_plan
from image_analogies_tpu_torch.runtime.supervisor import DispatchDeadline
from image_analogies_tpu_torch.serving.daemon import (
    SynthDaemon,
    _deadline_from_manifest,
)
from image_analogies_tpu_torch.serving.excache import (
    OBSERVED_WARMUP_FILE,
    load_observed_warmup,
    merge_warmup_entries,
    save_observed_warmup,
)
from image_analogies_tpu_torch.serving.journal import (
    LOCK_FILE,
    RequestJournal,
    acquire_lock,
    journal_path,
    release_lock,
)
from image_analogies_tpu_torch.serving.queueing import AdmissionController
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.sentinel import (
    check_serving_recovery,
)

_SERVE_CFG = dict(
    levels=2, matcher="patchmatch", pallas_mode="off",
    em_iters=1, pm_iters=2,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _body(frame: np.ndarray) -> bytes:
    return json.dumps({
        "image_b64": base64.b64encode(
            np.ascontiguousarray(frame.astype(np.float32)).tobytes()
        ).decode(),
        "shape": list(frame.shape),
        "dtype": "float32",
    }).encode()


def _post(url: str, path: str, body: bytes, timeout: float = 300.0):
    """(status, parsed-json, headers) for a POST."""
    req = urllib.request.Request(
        url + path, data=body, method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(
                resp.headers
            )
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get_json(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _response_sha(resp: dict) -> str:
    return hashlib.sha256(
        base64.b64decode(resp["image_b64"])
    ).hexdigest()


def _manifest(n: int) -> dict:
    # A syntactically-valid journal manifest (scan tests never decode
    # the pixels, so a tiny payload keeps rotation arithmetic easy).
    return {"shape": [8, 8, 3], "dtype": "float32",
            "image_b64": "A" * 64, "n": n}


# ------------------------------------------------ journal scan/write
class TestJournalScan:
    def _write_lines(self, path, lines):
        with open(path, "wb") as fh:
            for line in lines:
                fh.write(line)

    def test_torn_trailing_line_skipped(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        full = [
            (json.dumps({"kind": "req", "request_id": f"r{i}",
                         "ts": 1.0, "manifest": _manifest(i)})
             + "\n").encode()
            for i in range(2)
        ]
        torn = b'{"kind":"req","request_id":"torn","mani'
        self._write_lines(path, full + [torn])
        j = RequestJournal(path)
        counts = j.counts()
        assert counts["appended"] == 2
        assert counts["pending"] == 2
        assert [e["request_id"] for e in j.pending_entries()] == [
            "r0", "r1",
        ]

    def test_orphan_mark_ignored(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        self._write_lines(path, [
            (json.dumps({"kind": "mark", "request_id": "ghost",
                         "outcome": "done"}) + "\n").encode(),
        ])
        counts = RequestJournal(path).counts()
        assert counts["appended"] == 0
        assert counts["done"] == 0

    def test_mark_retires_and_is_idempotent(self, tmp_path):
        j = RequestJournal(str(tmp_path / "journal.jsonl"))
        assert j.append("r1", _manifest(1))
        assert j.mark("r1", "done") is True
        assert j.mark("r1", "done") is False
        counts = j.counts()
        assert counts == {
            "appended": 1, "pending": 0, "errors": 0,
            "done": 1, "replayed": 0, "cancelled": 0,
        }
        j.close()

    def test_bad_outcome_raises(self, tmp_path):
        j = RequestJournal(str(tmp_path / "journal.jsonl"))
        j.append("r1", _manifest(1))
        with pytest.raises(ValueError, match="outcome"):
            j.mark("r1", "vanished")

    def test_rotation_preserves_pending_across_restart(self, tmp_path):
        """The mid-replay rotation boundary: entries that rotated into
        `.1` must still scan as pending, and a mark written AFTER the
        rotation (into the live generation) must retire a request
        journaled BEFORE it."""
        path = str(tmp_path / "journal.jsonl")
        j = RequestJournal(path, max_bytes=1024)
        for i in range(12):  # ~200 bytes/line -> at least one rotation
            j.append(f"r{i}", _manifest(i))
        j.close()
        assert os.path.exists(path + ".1"), "rotation never happened"

        j2 = RequestJournal(path, max_bytes=1024)
        counts = j2.counts()
        assert counts["appended"] == 12
        assert counts["pending"] == 12
        # r0 lives in the rotated generation; its mark goes live.
        assert j2.mark("r0", "replayed") is True
        j2.close()

        counts3 = RequestJournal(path, max_bytes=1024).counts()
        assert counts3["pending"] == 11
        assert counts3["replayed"] == 1


class TestJournalRotationCost:
    def test_backlog_past_max_bytes_rewrites_linearly(self, tmp_path,
                                                      monkeypatch):
        """A pending backlog larger than max_bytes (a few 1024^2
        manifests under the default) must not rewrite the whole backlog
        on every write: the bytes written stay within a small multiple
        of the bytes appended, and every entry stays pending."""
        import image_analogies_tpu_torch.serving.journal as journal

        written = []
        real_write = journal.os.write

        def counting(fd, data):
            written.append(len(data))
            return real_write(fd, data)

        monkeypatch.setattr(journal.os, "write", counting)
        j = RequestJournal(str(tmp_path / "journal.jsonl"),
                           max_bytes=4096)
        big = dict(_manifest(0), image_b64="A" * 3000)
        for i in range(40):
            j.append(f"r{i}", big)
        j.close()
        appended = 40 * len(json.dumps(big))
        assert sum(written) < 4 * appended, (sum(written), appended)
        counts = RequestJournal(str(tmp_path / "journal.jsonl"),
                                max_bytes=4096).counts()
        assert counts["appended"] == 40 and counts["pending"] == 40


class TestJournalDiskfull:
    def test_write_failure_counted_not_raised(self, tmp_path):
        set_fault_plan("serve_diskfull:0:fail")
        try:
            j = RequestJournal(str(tmp_path / "journal.jsonl"))
            ok = j.append("r1", _manifest(1))  # write ordinal 0
            assert ok is False
            assert j.errors == 1
            # The in-memory ledger still books it: durability degraded,
            # accounting intact.
            assert j.counts()["pending"] == 1
            assert j.append("r2", _manifest(2)) is True
            j.close()
        finally:
            set_fault_plan(None)

    def test_ledger_published_to_registry(self, tmp_path):
        reg = MetricsRegistry()
        j = RequestJournal(str(tmp_path / "journal.jsonl"),
                           registry=reg)
        j.append("r1", _manifest(1))
        j.mark("r1", "done")
        j.close()
        dump = reg.to_dict()
        values = dump["ia_serve_journal"]["values"]
        by_field = {k: v for k, v in values.items()}
        assert any("appended" in k for k in by_field)
        assert sum(v for k, v in values.items() if "pending" in k) == 0


class TestStateDirLock:
    def test_live_holder_refuses_takeover(self, tmp_path):
        sd = str(tmp_path)
        acquire_lock(sd, pid=1)  # pid 1 is always alive
        with pytest.raises(RuntimeError, match="locked by live pid"):
            acquire_lock(sd)

    def test_stale_holder_reaped(self, tmp_path):
        sd = str(tmp_path)
        proc = subprocess.Popen([sys.executable, "-c", "pass"])
        proc.wait()
        acquire_lock(sd, pid=proc.pid)
        path = acquire_lock(sd)  # dead holder: silently reaped
        with open(path) as fh:
            assert int(fh.read()) == os.getpid()
        release_lock(sd)
        assert not os.path.exists(path)

    def test_release_never_clobbers_other_holder(self, tmp_path):
        sd = str(tmp_path)
        acquire_lock(sd, pid=1)
        release_lock(sd)  # we are not the holder
        assert os.path.exists(os.path.join(sd, LOCK_FILE))


# -------------------------------------------- deadline parse + price
class TestDeadlineParsing:
    @pytest.mark.parametrize("ms,expect", [
        (None, None), (250, 250.0), (1.5, 1.5), (3_600_000, 3.6e6),
    ])
    def test_valid(self, ms, expect):
        manifest = {} if ms is None else {"deadline_ms": ms}
        assert _deadline_from_manifest(manifest) == expect

    @pytest.mark.parametrize("ms", [
        True, "fast", 0, -5, 3_600_001, float("inf"), float("nan"),
    ])
    def test_invalid(self, ms):
        with pytest.raises(ValueError, match="deadline_ms"):
            _deadline_from_manifest({"deadline_ms": ms})


class TestDeadlinePermits:
    def test_no_deadline_admits(self):
        ac = AdmissionController(max_depth=8,
                                 registry=MetricsRegistry())
        assert ac.deadline_permits(None, 99, 99) is True

    def test_expired_deadline_sheds(self):
        ac = AdmissionController(max_depth=8,
                                 registry=MetricsRegistry())
        now = time.monotonic()
        assert ac.deadline_permits(now - 0.1, 0, 0, now=now) is False

    def test_no_history_admits(self):
        ac = AdmissionController(max_depth=8,
                                 registry=MetricsRegistry())
        now = time.monotonic()
        assert ac.deadline_permits(now + 0.05, 8, 1, now=now) is True

    def test_priced_against_backlog(self):
        reg = MetricsRegistry()
        h = reg.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        )
        for _ in range(8):
            h.observe(1000.0, labels={"phase": "service"})
        ac = AdmissionController(max_depth=8, registry=reg)
        now = time.monotonic()
        # 5 units of work ahead x ~1 s each vs a 500 ms budget: shed.
        assert ac.deadline_permits(now + 0.5, 3, 1, now=now) is False
        # The same backlog with a 30 s budget: admit.
        assert ac.deadline_permits(now + 30.0, 3, 1, now=now) is True


class TestDispatchDeadline:
    def test_armed_deadline_fires(self):
        dd = DispatchDeadline(0.05).arm()
        try:
            deadline = time.monotonic() + 5.0
            while not dd.expired and time.monotonic() < deadline:
                time.sleep(0.01)
            assert dd.expired
            assert dd.token.reason == "dispatch-deadline"
        finally:
            dd.cancel()

    def test_cancel_disarms(self):
        dd = DispatchDeadline(0.05).arm()
        dd.cancel()
        time.sleep(0.15)
        assert not dd.expired


# ------------------------------------------- observed-warmup drift
class TestObservedWarmup:
    def test_roundtrip_and_merge(self, tmp_path):
        path = str(tmp_path / OBSERVED_WARMUP_FILE)
        save_observed_warmup(path, [(24, 24, 3), (48, 32, 3)])
        observed = load_observed_warmup(path)
        assert observed == [
            {"height": 24, "width": 24, "channels": 3},
            {"height": 48, "width": 32, "channels": 3},
        ]
        manifest = [{"height": 24, "width": 24, "channels": 3}]
        merged = merge_warmup_entries(manifest, observed)
        assert len(merged) == 2  # the duplicate 24x24 collapses

    def test_missing_or_corrupt_is_empty(self, tmp_path):
        assert load_observed_warmup(str(tmp_path / "nope.json")) == []
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert load_observed_warmup(str(bad)) == []

    def test_undersized_entries_skipped(self, tmp_path):
        path = str(tmp_path / OBSERVED_WARMUP_FILE)
        save_observed_warmup(path, [(4, 4, 3), (24, 24, 3)])
        assert load_observed_warmup(path) == [
            {"height": 24, "width": 24, "channels": 3},
        ]


# ------------------------------------------ recovery-ledger sentinel
class TestServingRecoverySentinel:
    def _registry(self, appended=0, done=0, replayed=0, cancelled=0,
                  pending=0, errors=0, depth=None, inflight=None):
        reg = MetricsRegistry()
        g = reg.gauge("ia_serve_journal", "ledger")
        for field, v in (("appended", appended), ("done", done),
                         ("replayed", replayed),
                         ("cancelled", cancelled),
                         ("pending", pending)):
            g.set(float(v), labels={"field": field})
        reg.gauge("ia_serve_journal_errors", "errors").set(
            float(errors)
        )
        if depth is not None:
            reg.gauge("ia_serve_queue_depth", "d").set(float(depth))
        if inflight is not None:
            reg.gauge("ia_serve_inflight", "i").set(float(inflight))
        return reg.to_dict()

    def test_silent_family_skipped(self):
        check = check_serving_recovery(MetricsRegistry().to_dict())
        assert check["status"] == "skipped"

    def test_balanced_ledger_ok(self):
        check = check_serving_recovery(self._registry(
            appended=4, done=2, replayed=1, cancelled=1, pending=0,
        ))
        assert check["status"] == "ok", check

    def test_lost_request_violated(self):
        check = check_serving_recovery(self._registry(
            appended=5, done=2, replayed=1, cancelled=0, pending=1,
        ))
        assert check["status"] == "violated"
        assert "fell out of the ledger" in check["detail"]

    def test_negative_pending_violated(self):
        check = check_serving_recovery(self._registry(
            appended=1, done=2, pending=-1,
        ))
        assert check["status"] == "violated"
        assert "negative" in check["detail"]

    def test_pending_at_quiescence_degraded(self):
        check = check_serving_recovery(self._registry(
            appended=3, done=1, pending=2, depth=0, inflight=0,
        ))
        assert check["status"] == "degraded"
        assert "unreplayed takeover debt" in check["detail"]

    def test_pending_with_backlog_ok(self):
        check = check_serving_recovery(self._registry(
            appended=3, done=1, pending=2, depth=1, inflight=1,
        ))
        assert check["status"] == "ok", check

    def test_write_errors_degraded_never_violated(self):
        check = check_serving_recovery(self._registry(
            appended=2, done=2, errors=3,
        ))
        assert check["status"] == "degraded"
        assert "durability accounting" in check["detail"]


# ------------------------------------- end-to-end: journal -> replay
@pytest.fixture(scope="module")
def resilience_scenario(tmp_path_factory):
    """Two in-process daemons on ONE state dir: daemon 1
    serves a request (journals it, retires it `done`), inherits a
    simulated crash-pending entry, drains (503 for new work, observed-
    warmup snapshot, lock released); daemon 2 takes over the same
    state dir and replays the pending entry bit-identically."""
    state_dir = str(tmp_path_factory.mktemp("serve-state"))
    rng = np.random.default_rng(16)
    a, ap, b = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)
    )
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    body = _body(b)
    out = {}
    prev = None
    try:
        reg1 = MetricsRegistry()
        prev = set_registry(reg1)
        daemon1 = SynthDaemon(
            a, ap, cfg, registry=reg1, max_batch=1, max_wait_ms=5.0,
            max_queue_depth=8, cache_capacity=4, max_retries=1,
            observability=False, state_dir=state_dir,
            drain_deadline_s=30.0,
        ).start()
        try:
            out["live"] = _post(daemon1.url, "/synthesize", body)
            out["sha_live"] = _response_sha(out["live"][1])
            # Simulate the crash window: a request journaled at
            # admission whose daemon died before responding.
            daemon1.journal.append(
                "crash-pending-1", json.loads(body)
            )
            out["journal_route"] = _get_json(daemon1.url + "/journal")
            out["drain"] = _post(daemon1.url, "/drain", b"{}")
            out["post_during_drain"] = _post(
                daemon1.url, "/synthesize", body
            )
            out["drained"] = daemon1.drained.wait(30.0)
            out["observed"] = load_observed_warmup(
                os.path.join(state_dir, OBSERVED_WARMUP_FILE)
            )
        finally:
            daemon1.stop()
        out["lock_released"] = not os.path.exists(
            os.path.join(state_dir, LOCK_FILE)
        )
        out["ledger_after_stop"] = RequestJournal(
            journal_path(state_dir)
        ).counts()

        reg2 = MetricsRegistry()
        set_registry(reg2)
        daemon2 = SynthDaemon(
            a, ap, cfg, registry=reg2, max_batch=1, max_wait_ms=5.0,
            max_queue_depth=8, cache_capacity=4, max_retries=1,
            observability=False, state_dir=state_dir,
            drain_deadline_s=30.0,
        ).start()
        try:
            out["replay_enqueued"] = daemon2.replay_journal()
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                if daemon2.journal.counts()["pending"] == 0:
                    break
                time.sleep(0.05)
            out["ledger_after_replay"] = daemon2.journal.counts()
            out["replay_records"] = dict(daemon2._replayed)
            out["journal_route2"] = _get_json(
                daemon2.url + "/journal"
            )
            out["live2"] = _post(daemon2.url, "/synthesize", body)
            out["sha_live2"] = _response_sha(out["live2"][1])

            # Queued-cancellation units against the live daemon: a
            # dead client socket and a blown deadline never dispatch.
            req_dead = daemon2._make_request(b)
            req_dead.alive = lambda: False
            req_exp = daemon2._make_request(b)
            req_exp.deadline_t = time.monotonic() - 1.0
            kept = daemon2._filter_batch([req_dead, req_exp])
            out["filter_kept"] = len(kept)
            out["cancel_status"] = (req_dead.status, req_exp.status)
            out["cancel_done"] = (
                req_dead.done.is_set(), req_exp.done.is_set()
            )
            out["cancel_errors"] = (req_dead.error, req_exp.error)
            out["sentinel"] = check_serving_recovery(reg2.to_dict())
        finally:
            daemon2.stop()
    finally:
        if prev is not None:
            set_registry(prev)
    return out


class TestJournalReplayEndToEnd:
    def test_live_request_journals_done(self, resilience_scenario):
        code, resp, _ = resilience_scenario["live"]
        assert code == 200 and resp["status"] == "ok"
        ledger = resilience_scenario["journal_route"]["ledger"]
        assert ledger["done"] == 1

    def test_journal_route_shape(self, resilience_scenario):
        snap = resilience_scenario["journal_route"]
        assert snap["ledger"]["appended"] == 2
        assert snap["ledger"]["pending"] == 1
        assert snap["draining"] is False
        assert snap["replayed"] == {}

    def test_drain_503s_new_work(self, resilience_scenario):
        code, resp, _ = resilience_scenario["drain"]
        assert code == 202 and resp["status"] == "draining"
        code, resp, headers = resilience_scenario["post_during_drain"]
        assert code == 503
        assert resp["status"] == "unavailable"
        assert "Retry-After" in headers

    def test_drain_quiesces_and_snapshots(self, resilience_scenario):
        assert resilience_scenario["drained"] is True
        assert resilience_scenario["observed"] == [
            {"height": 24, "width": 24, "channels": 3},
        ]
        assert resilience_scenario["lock_released"] is True

    def test_pending_survives_restart(self, resilience_scenario):
        # Drain compacts the journal down to its pending entries
        # (round 21): retired done history is dropped on disk, the
        # pending set survives verbatim.
        ledger = resilience_scenario["ledger_after_stop"]
        assert ledger["pending"] == 1
        assert ledger["done"] == 0

    def test_takeover_replays_zero_loss(self, resilience_scenario):
        assert resilience_scenario["replay_enqueued"] == 1
        ledger = resilience_scenario["ledger_after_replay"]
        assert ledger["pending"] == 0
        assert ledger["replayed"] == 1
        # The drained journal was compacted to its 1 pending entry,
        # so the successor's scan sees exactly that line.
        assert ledger["appended"] == 1

    def test_replay_bit_identical(self, resilience_scenario):
        rec = resilience_scenario["replay_records"]["crash-pending-1"]
        assert rec["sha256"] == resilience_scenario["sha_live"]
        assert rec["sha256"] == resilience_scenario["sha_live2"]
        assert rec["shape"] == [24, 24, 3]

    def test_journal_route_reports_replays(self, resilience_scenario):
        snap = resilience_scenario["journal_route2"]
        assert "crash-pending-1" in snap["replayed"]

    def test_queued_cancellations(self, resilience_scenario):
        assert resilience_scenario["filter_kept"] == 0
        assert resilience_scenario["cancel_status"] == (
            "cancelled", "cancelled"
        )
        assert resilience_scenario["cancel_done"] == (True, True)
        dead_err, exp_err = resilience_scenario["cancel_errors"]
        assert "disconnected" in dead_err
        assert "deadline" in exp_err

    def test_recovery_sentinel_grades_ok(self, resilience_scenario):
        check = resilience_scenario["sentinel"]
        assert check["status"] == "ok", check


# ------------------------------------- serving fault points, live
@pytest.fixture(scope="module")
def fault_scenario():
    """One daemon with a 1 s dispatch deadline: client dispatch 0 hangs
    under `serve_hang` (bounded by the deadline: 500, then the daemon
    serves on), dispatch 2 runs after a forced epoch eviction under
    `serve_evict` (an honest miss, the same answer)."""
    rng = np.random.default_rng(5)
    a, ap, b = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)
    )
    reg = MetricsRegistry()
    prev = set_registry(reg)
    out = {}
    daemon = SynthDaemon(
        a, ap, SynthConfig(device="cpu", **_SERVE_CFG), registry=reg,
        max_batch=1, max_wait_ms=5.0, observability=False,
        dispatch_deadline_s=1.0, obs_interval_s=0,
    ).start()
    try:
        set_fault_plan("serve_hang:0:hang:60,serve_evict:2:fail")
        t0 = time.monotonic()
        out["hung"] = _post(daemon.url, "/synthesize", _body(b))
        out["hung_s"] = time.monotonic() - t0
        out["first"] = _post(daemon.url, "/synthesize", _body(b))
        out["evicted"] = _post(daemon.url, "/synthesize", _body(b))
        out["after"] = _post(daemon.url, "/synthesize", _body(b))
        # A 1 ms budget against the observed service time: shed at
        # admission, with a Retry-After like any shed.
        out["deadline"] = _post(daemon.url, "/synthesize", json.dumps(
            dict(json.loads(_body(b)), deadline_ms=1)).encode())
        out["metrics"] = reg.to_dict()
    finally:
        set_fault_plan(None)
        daemon.stop()
        set_registry(prev)
    return out


class TestServeFaultPoints:
    def test_hang_bounded_by_dispatch_deadline(self, fault_scenario):
        code, resp, _ = fault_scenario["hung"]
        assert code == 500 and resp["status"] == "failed"
        assert fault_scenario["hung_s"] < 30.0
        # The aborted dispatch never reached the cache: this is the
        # key's first use.
        code, resp, _ = fault_scenario["first"]
        assert code == 200 and resp["cache"] == "miss"

    def test_eviction_is_an_honest_miss_same_answer(self, fault_scenario):
        code, resp, _ = fault_scenario["evicted"]
        assert code == 200 and resp["cache"] == "miss"
        assert _response_sha(resp) == _response_sha(
            fault_scenario["first"][1])
        code, resp, _ = fault_scenario["after"]
        assert code == 200 and resp["cache"] == "hit"
        evictions = fault_scenario["metrics"][
            "ia_serve_excache_evictions_total"]["values"]["total"]
        assert evictions == 1

    def test_deadline_shed_carries_retry_after(self, fault_scenario):
        code, resp, headers = fault_scenario["deadline"]
        assert code == 429 and resp["status"] == "shed"
        assert "deadline" in resp["error"]
        assert resp["retry_after_s"] >= 1.0
        assert int(headers["Retry-After"]) >= 1

    def test_injections_booked(self, fault_scenario):
        fired = fault_scenario["metrics"]["ia_fault_injections_total"][
            "values"]
        assert fired == {
            '{action="hang",point="serve_hang"}': 1,
            '{action="fail",point="serve_evict"}': 1,
        }


def test_serving_fault_grammar():
    from image_analogies_tpu_torch.runtime.faults import FaultPlan

    plan = FaultPlan.parse(
        "serve_crash:3:fail,serve_hang:0:hang:2,serve_evict:1:fail,"
        "serve_diskfull:0:fail")
    assert plan.armed() == [
        ("serve_crash", 3, "fail"), ("serve_hang", 0, "hang"),
        ("serve_evict", 1, "fail"), ("serve_diskfull", 0, "fail"),
    ]
    for bad in ("serve_crash:0:raise", "serve_evict:0:hang:1",
                "serve_diskfull:0:truncate"):
        with pytest.raises(ValueError, match="only supports"):
            FaultPlan.parse(bad)


# --------------------------------- each package reads the other's files
def _write_journal(journal_cls, path):
    """r0 done, r1 cancelled, r2 and r3 pending, one torn line."""
    j = journal_cls(path)
    for i in range(4):
        j.append(f"r{i}", _manifest(i))
    j.mark("r0", "done")
    j.mark("r1", "cancelled")
    j.close()
    with open(path, "ab") as fh:
        fh.write(b'{"kind":"req","request_id":"torn","mani')


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_read_across_packages(tmp_path, writer):
    from image_analogies_tpu.serving import journal as j_journal

    path = str(tmp_path / "journal.jsonl")
    write = j_journal.RequestJournal if writer == "jax" else RequestJournal
    _write_journal(write, path)
    views = [cls(path) for cls in (j_journal.RequestJournal,
                                   RequestJournal)]
    assert views[1].counts() == views[0].counts() == {
        "appended": 4, "pending": 2, "errors": 0,
        "done": 1, "replayed": 0, "cancelled": 1,
    }
    assert views[1].pending_entries() == views[0].pending_entries()
    assert [e["request_id"] for e in views[1].pending_entries()] == [
        "r2", "r3"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_observed_warmup_read_across_packages(tmp_path, writer):
    from image_analogies_tpu.serving import excache as j_ex

    path = str(tmp_path / OBSERVED_WARMUP_FILE)
    shapes = [(24, 24, 3), (1024, 1024, 3), (4, 4, 3), (48, 32, 1)]
    save = (j_ex.save_observed_warmup if writer == "jax"
            else save_observed_warmup)
    save(path, shapes)
    want = j_ex.load_observed_warmup(path)
    assert load_observed_warmup(path) == want == [
        {"height": 24, "width": 24, "channels": 3},
        {"height": 1024, "width": 1024, "channels": 3},
        {"height": 48, "width": 32, "channels": 1},
    ]
    assert merge_warmup_entries(want[:1], want) == \
        j_ex.merge_warmup_entries(want[:1], want)


def test_admission_counts_requests_in_their_journal_append(tmp_path,
                                                          monkeypatch):
    """Admitted requests still in their journal append count against
    the depth limit: six simultaneous clients against a limit of 2,
    with each append held 0.5 s, get exactly 2 answers and 4 sheds
    (deciding on queue depth + in flight alone admitted all six)."""
    import threading

    import image_analogies_tpu_torch.serving.journal as journal

    real_append = journal.RequestJournal.append

    def slow_append(self, request_id, manifest):
        time.sleep(0.5)
        return real_append(self, request_id, manifest)

    monkeypatch.setattr(journal.RequestJournal, "append", slow_append)
    rng = np.random.default_rng(8)
    a, ap, b = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)
    )
    reg = MetricsRegistry()
    prev = set_registry(reg)
    daemon = SynthDaemon(
        a, ap, SynthConfig(device="cpu", **_SERVE_CFG), registry=reg,
        max_batch=1, max_wait_ms=5.0, max_queue_depth=2,
        observability=False, obs_interval_s=0,
        state_dir=str(tmp_path / "state"),
    ).start()
    codes = []
    try:
        go = threading.Barrier(6)

        def client():
            go.wait()
            codes.append(_post(daemon.url, "/synthesize", _body(b))[0])

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert daemon._backlog == 0
    finally:
        daemon.stop()
        set_registry(prev)
    assert sorted(codes) == [200, 200, 429, 429, 429, 429]


def test_backlog_ledger_under_thread_stress(tmp_path):
    """More client threads than cores against a depth limit of 3, with
    the interpreter switching threads every microsecond: the backlog
    returns to 0 and the admission ledger balances (requests = admitted
    + shed, admitted = completed + failed), which a lost update to the
    shared backlog would break."""
    import threading

    rng = np.random.default_rng(9)
    a, ap, b = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)
    )
    reg = MetricsRegistry()
    prev = set_registry(reg)
    interval = sys.getswitchinterval()
    daemon = SynthDaemon(
        a, ap, SynthConfig(device="cpu", **_SERVE_CFG), registry=reg,
        max_batch=2, max_wait_ms=2.0, max_queue_depth=3,
        observability=False, obs_interval_s=0,
        state_dir=str(tmp_path / "state"),
    ).start()
    codes = []
    try:
        sys.setswitchinterval(1e-6)
        n = 4 * (os.cpu_count() or 1) + 4
        go = threading.Barrier(n)

        def client():
            go.wait()
            codes.append(_post(daemon.url, "/synthesize", _body(b))[0])

        threads = [threading.Thread(target=client) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        sys.setswitchinterval(interval)
        backlog = daemon._backlog
        ledger = daemon.journal.counts()
        metrics = reg.to_dict()
    finally:
        sys.setswitchinterval(interval)
        daemon.stop()
        set_registry(prev)

    def total(name):
        return sum(metrics.get(name, {}).get("values", {}).values())

    assert backlog == 0
    assert len(codes) == n and set(codes) <= {200, 429} and 200 in codes
    assert total("ia_serve_requests_total") == n
    assert total("ia_serve_admitted_total") + total(
        "ia_serve_shed_total") == n
    assert total("ia_serve_admitted_total") == total(
        "ia_serve_completed_total") + total("ia_serve_failed_total")
    assert codes.count(200) == total("ia_serve_completed_total")
    assert ledger["pending"] == 0 and ledger["done"] == codes.count(200)


def test_session_survives_drain_and_takeover(tmp_path):
    """A session's carried state crosses a drain: daemon 1 serves the
    session's first frame and drains (sessions.json + the stream's
    snapshot); daemon 2 on the same state dir restores it, and the
    session's second frame equals a `VideoStream` stepped over both
    frames by hand, bit for bit (warm, not a cold restart)."""
    from image_analogies_tpu_torch.serving.daemon import _luma_bucket
    from image_analogies_tpu_torch.video.sequence import VideoStream

    rng = np.random.default_rng(10)
    a, ap, f0, f1 = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(4)
    )
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    state = str(tmp_path / "state")
    kw = dict(max_batch=1, max_wait_ms=5.0, observability=False,
              obs_interval_s=0, state_dir=state)

    def body(frame):
        return json.dumps(dict(json.loads(_body(frame)),
                               session_id="clip-a")).encode()

    prev = set_registry(MetricsRegistry())
    try:
        d1 = SynthDaemon(a, ap, cfg, registry=MetricsRegistry(),
                         **kw).start()
        try:
            first = _post(d1.url, "/synthesize", body(f0))
            d1.begin_drain()
            assert d1.drained.wait(30.0)
        finally:
            d1.stop()
        d2 = SynthDaemon(a, ap, cfg, registry=MetricsRegistry(),
                         **kw).start()
        try:
            restored = d2.restore_sessions()
            second = _post(d2.url, "/synthesize", body(f1))
            warm = d2._sessions["clip-a"].warm_frames
        finally:
            d2.stop()
    finally:
        set_registry(prev)
    assert first[0] == second[0] == 200 and restored == 1
    stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(f0))
    want0 = stream.step(f0).numpy()
    want1 = stream.step(f1).numpy()
    got = [np.frombuffer(base64.b64decode(r[1]["image_b64"]), np.float32)
           .reshape(r[1]["shape"]) for r in (first, second)]
    np.testing.assert_array_equal(got[0], want0)
    np.testing.assert_array_equal(got[1], want1)
    assert warm == 1

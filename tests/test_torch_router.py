"""The fleet router of the port (`serving/router.py`, session adoption in
`serving/daemon.py`, the fleet CLI) against the JAX package's, on the
CPU:

  - the reference's unit classes (tests/test_router.py: routing over stub
    replicas, the fleet watches, the observed-warmup merge, the journal
    compaction, session migration), run against the port's modules;
  - `_pick` parity: both packages' routers make the same decisions over
    one scripted sequence of replica snapshots;
  - a port router over three port daemons at grain 2: every answer
    equals the port library's dispatch of that frame at the grain, bit
    for bit; a replica whose socket is gone is marked down and the
    request retried on a survivor; a session drained off its replica
    and adopted by another equals `VideoStream` stepped by hand;
  - the JAX package's router in front of port brute daemons: the two
    speak one wire format, and the answers are >= 100 dB from a JAX
    daemon's;
  - the CLI: `serve` with `--lattice --warm-dir --archive-dir
    --archive-interval-s`, `route` (which never initialises CUDA),
    `trace --fleet`, `obs`, `history` and `incident` in their own
    processes or in-process.

Frames are 20^2-32^2, two levels, one or two EM steps; torch runs on one
intra-op thread."""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import test_router as ref  # noqa: E402
from check_fleet_trace import _validate_joined  # noqa: E402
from check_obs import validate_obs  # noqa: E402
from image_analogies_tpu.config import SynthConfig as JCfg  # noqa: E402
from image_analogies_tpu.parallel.mesh import make_mesh  # noqa: E402
from image_analogies_tpu.serving import daemon as j_daemon  # noqa: E402
from image_analogies_tpu.serving import router as j_router  # noqa: E402
from image_analogies_tpu.telemetry import metrics as j_metrics  # noqa: E402
from image_analogies_tpu_torch import psnr, synthesize_batch  # noqa: E402
from image_analogies_tpu_torch.cli import main as cli_main  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving import router as t_router  # noqa: E402
from image_analogies_tpu_torch.serving.daemon import (  # noqa: E402
    SynthDaemon,
    _luma_bucket,
)
from image_analogies_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.spans import Tracer  # noqa: E402
from image_analogies_tpu_torch.utils.io import save_image  # noqa: E402
from image_analogies_tpu_torch.video.sequence import VideoStream  # noqa: E402
from test_torch_serving import (  # noqa: E402
    _SERVE_CFG,
    _body,
    _image,
    _pair_frames,
    _post,
    _post_together,
)
from torch_ref_swap import swap  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
GRAIN = 2


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
    assert ref.FleetRouter is t_router.FleetRouter
    assert ref.load_discovery is t_router.load_discovery


# ------------------------------------- the reference's unit classes
class TestFleetRouterRouting(ref.TestFleetRouterRouting):
    pass


class TestFleetWatches(ref.TestFleetWatches):
    pass


class TestJournalCompact(ref.TestJournalCompact):
    pass


class TestObservedWarmupMerge:
    """The reference's warm-tier cases on the observed-warmup file (its
    index cases are the port's own, in test_torch_persist.py: the port's
    index seals shapes, not executables)."""

    test_observed_warmup_merge_unions_across_writers = (
        ref.TestWarmTierMerge.
        test_observed_warmup_merge_unions_across_writers)
    test_observed_warmup_overwrites_without_merge = (
        ref.TestWarmTierMerge.test_observed_warmup_overwrites_without_merge)


def _sha(doc):
    return hashlib.sha256(_image(doc).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def migration_scenario(tmp_path_factory):
    """The reference's migration scenario on port daemons: replica A
    serves session frames 1-2 and drains (the compaction spied to see
    sessions.json already on disk), replica B adopts the session over
    POST /sessions/adopt and serves frame 3; the reference frames come
    from the port's `VideoStream` stepped by hand."""
    state_a = str(tmp_path_factory.mktemp("router-state-a"))
    state_b = str(tmp_path_factory.mktemp("router-state-b"))
    rng = np.random.default_rng(21)
    a, ap = (rng.random((24, 24, 3)).astype(np.float32) for _ in range(2))
    f0 = rng.random((24, 24, 3)).astype(np.float32)
    f1 = f0.copy()
    f1[:4, :4] = rng.random((4, 4, 3)).astype(np.float32)
    f2 = f1.copy()
    f2[4:8, 4:8] = rng.random((4, 4, 3)).astype(np.float32)
    frames = [f0, f1, f2]
    cfg = SynthConfig(device="cpu", levels=2, matcher="patchmatch",
                      pallas_mode="off", em_iters=2, pm_iters=4)
    out = {}
    stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(f0))
    for i, f in enumerate(frames):
        if i == 2:
            before = (stream.run_units, stream.cold_units)
        want = stream.step(f)
    out["ref_sha3"] = hashlib.sha256(
        want.numpy().astype(np.float32).tobytes()).hexdigest()
    out["ref_frame3_units"] = (stream.run_units - before[0],
                               stream.cold_units - before[1])

    def spawn(state_dir):
        reg = MetricsRegistry()
        prev = set_registry(reg)
        d = SynthDaemon(a, ap, cfg, registry=reg, state_dir=state_dir,
                        max_batch=1, max_wait_ms=5.0, max_queue_depth=8,
                        cache_capacity=4, obs_interval_s=0).start()
        return d, prev

    da, prev = spawn(state_a)
    try:
        for f in frames[:2]:
            assert _post(da.url, _body(f, session_id="mig"))[0] == 200
        orig_compact = da.journal.compact
        seen = {}

        def spy_compact():
            seen["sessions_json_at_compact"] = os.path.exists(
                os.path.join(state_a, "sessions.json"))
            return orig_compact()

        da.journal.compact = spy_compact
        da._drain_snapshot()
        out["drain_order"] = seen
    finally:
        da.stop()
        set_registry(prev)
    db, prev = spawn(state_b)
    try:
        out["adopt"] = ref._post_json(db.url + "/sessions/adopt", {
            "state_dir": state_a, "sessions": ["mig"]})
        out["bad_adopt"] = ref._post_json(db.url + "/sessions/adopt",
                                          {"sessions": ["mig"]})
        s = db._sessions.get("mig")
        out["adopted_t"] = None if s is None else s.t
        code, doc, _ = _post(db.url, _body(frames[2], session_id="mig"))
        assert code == 200
        out["mig_sha3"] = _sha(doc)
        s = db._sessions["mig"]
        out["mig_frame3_units"] = (s.run_units, s.cold_units)
        out["mig_warm_frames"] = s.warm_frames
    finally:
        db.stop()
        set_registry(prev)
    return out


class TestSessionMigration(ref.TestSessionMigration):
    pass


# ------------------------------------------------------ _pick parity
_PICK_SCRIPT = [
    ("state", "r0", dict(queue_depth=2, inflight=1)),
    ("state", "r1", dict(queue_depth=0, inflight=0)),
    ("state", "r2", dict(queue_depth=1, inflight=0)),
    ("pick", None, None),
    ("pick", None, None),
    ("pick", "s1", None),
    ("pick", "s1", None),
    ("settle", "r1", True),
    ("pick", "s2", "r1"),
    ("state", "r2", dict(draining=True)),
    ("pick", "s2", None),
    ("pick", "s1", None),
    ("state", "r1", dict(alive=False)),
    ("pick", "s1", None),
    ("settle", "r0", False),
    ("pick", None, "r0"),
    ("state", "r0", dict(alive=False)),
    ("pick", None, None),
]


def _run_picks(mod, metrics_mod):
    router = mod.FleetRouter(metrics_mod.MetricsRegistry())
    for name in ("r0", "r1", "r2"):
        h = mod.ReplicaHandle(name, f"http://{name}")
        h.alive = True
        router._replicas[name] = h
    out = []
    for op, a, b in _PICK_SCRIPT:
        if op == "state":
            for k, v in b.items():
                setattr(router._replicas[a], k, v)
        elif op == "settle":
            router._settle(router._replicas[a], b)
        else:
            h, result, considered = router._pick(a, exclude=b)
            out.append((h.name if h else None, result, considered))
    return out, dict(router.affinity_counts), [
        h.snapshot() for h in router._replicas.values()]


def test_pick_decisions_equal_jax():
    from image_analogies_tpu_torch.telemetry import metrics as t_metrics

    got = _run_picks(t_router, t_metrics)
    assert got == _run_picks(j_router, j_metrics)
    assert got[0][0][0] == "r1" and got[0][-1][0] is None


# ------------------------------------------------- the fleet, end to end
def _dispatch(a, ap, frame, cfg, grain=GRAIN):
    out = synthesize_batch(a, ap, np.stack([frame] * grain), cfg,
                           frame_indices=[0] * grain,
                           _b_stats=_luma_bucket(frame))
    return out[0].numpy()


@pytest.fixture(scope="module")
def fleet_scenario(tmp_path_factory):
    """Three port daemons (state dirs, grain 2) behind a traced port
    router whose poller is parked (it polls on add): a burst of four
    frames; replica r0's socket closed and one more frame; a session of
    three frames, pinned to r1, drained off it by the router after
    frame 2 and adopted by r2."""
    rng = np.random.default_rng(30)
    a = rng.random((24, 24, 3)).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random(a.shape), 0, 1).astype(
        np.float32)
    frames = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(5)]
    clip = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)]
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    work = tmp_path_factory.mktemp("fleet")
    daemons, out = [], {}
    reg = MetricsRegistry()
    router = t_router.FleetRouter(
        reg, tracer=Tracer(registry=reg), poll_interval_s=60.0,
        discovery_path=str(work / "fleet.json"),
        access_log_path=str(work / "router_access.jsonl"),
    ).start()
    try:
        for i in range(3):
            dreg = MetricsRegistry()
            d = SynthDaemon(a, ap, cfg, registry=dreg, max_batch=GRAIN,
                            max_wait_ms=20.0, obs_interval_s=0,
                            state_dir=str(work / f"state{i}")).start()
            daemons.append(d)
            router.add_replica(d.url)
        out["burst"] = _post_together(router.url,
                                      [_body(f) for f in frames[:4]])
        daemons[0].live.stop()
        out["retried"] = _post(router.url, _body(frames[4]))
        out["retries"] = router.retries
        out["r0_alive"] = router._replicas["r0"].alive
        out["session"] = [_post(router.url, _body(f, session_id="clip"))
                          for f in clip[:2]]
        out["drain"] = router.drain_replica("r1", wait_s=60.0)
        out["session"].append(_post(router.url,
                                    _body(clip[2], session_id="clip")))
        out["fleet"] = ref._get_json(router.url + "/fleet")
        out["metrics"] = reg.to_dict()
    finally:
        router.stop()
        for d in daemons:
            d.stop()
    stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(clip[0]))
    out["refs"] = [_dispatch(a, ap, f, cfg) for f in frames]
    out["clip_refs"] = [stream.step(f).numpy() for f in clip]
    return out


class TestFleetEndToEnd:
    def test_burst_equals_the_library(self, fleet_scenario):
        s = fleet_scenario
        routed = set()
        for i, (code, doc, hdrs) in enumerate(s["burst"]):
            assert code == 200, doc
            np.testing.assert_array_equal(_image(doc), s["refs"][i])
            routed.add(hdrs["X-Routed-To"])
        assert len(routed) >= 2

    def test_dead_replica_is_retried_on_a_survivor(self, fleet_scenario):
        s = fleet_scenario
        code, doc, hdrs = s["retried"]
        assert code == 200 and hdrs["X-Routed-To"] != "r0"
        np.testing.assert_array_equal(_image(doc), s["refs"][4])
        assert s["retries"] == 1 and s["r0_alive"] is False
        vals = s["metrics"]["ia_route_retries_total"]["values"]
        assert vals == {'{reason="conn_error"}': 1}

    def test_session_drained_and_adopted_equals_videostream(
        self, fleet_scenario
    ):
        s = fleet_scenario
        assert [h["X-Routed-To"] for _, _, h in s["session"]] == [
            "r1", "r1", "r2"]
        assert s["drain"]["drained"] is True
        assert s["drain"]["sessions_migrated"] == ["clip"]
        assert s["drain"]["migrated_to"] == "r2"
        for (code, doc, _), want in zip(s["session"], s["clip_refs"]):
            assert code == 200
            np.testing.assert_array_equal(_image(doc), want)
        assert s["fleet"]["migrations_total"] == 1
        # Frame 3 follows the drain's re-pin: a hit, no re-pin.
        assert (s["fleet"]["affinity"]["hit"],
                s["fleet"]["affinity"]["repin"]) == (2, 0)


@pytest.fixture(scope="module")
def wire_pair():
    """Three frames at once, grain 3, brute: to a JAX daemon, and through
    the JAX package's router to two port daemons."""
    a, ap, frames = _pair_frames()
    kw = dict(levels=2, matcher="brute", em_iters=1)
    bodies = [_body(f) for f in frames]
    jd = j_daemon.SynthDaemon(
        a, ap, JCfg(**kw), registry=j_metrics.MetricsRegistry(),
        mesh=make_mesh(1), max_batch=3, max_wait_ms=400.0,
        obs_interval_s=0,
    ).start()
    try:
        jax_out = _post_together(jd.url, bodies)
    finally:
        jd.stop()
    ports = [SynthDaemon(a, ap, SynthConfig(device="cpu", **kw),
                         registry=MetricsRegistry(), max_batch=3,
                         max_wait_ms=400.0, obs_interval_s=0).start()
             for _ in range(2)]
    router = j_router.FleetRouter(j_metrics.MetricsRegistry(),
                                  poll_interval_s=60.0).start()
    try:
        for d in ports:
            router.add_replica(d.url)
        port_out = _post_together(router.url, bodies)
    finally:
        router.stop()
        for d in ports:
            d.stop()
    return jax_out, port_out


def test_jax_router_over_port_daemons(wire_pair):
    for (jc, jr, _), (tc, tr, hdrs) in zip(*wire_pair):
        assert jc == tc == 200, (jr, tr)
        assert hdrs["X-Routed-To"] in ("r0", "r1")
        assert tr["request_id"] == hdrs["X-Request-Id"]
        assert psnr(_image(tr), _image(jr)) >= 100.0


# ------------------------------------------------------------ the CLI
def _await_live(proc, trace_dir, timeout=240):
    live = os.path.join(trace_dir, "live.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(live):
            with open(live) as fh:
                return json.load(fh)["url"]
        if proc.poll() is not None:
            raise RuntimeError(f"subprocess exited rc={proc.returncode}: "
                               + proc.stderr.read()[-2000:])
        time.sleep(0.1)
    raise RuntimeError("live.json never appeared")


# `route` in its own process: the router module touches no tensor, and
# the process exits with CUDA never initialised.
_ROUTE = ("import sys, torch; from image_analogies_tpu_torch import cli; "
          "rc = cli.main(sys.argv[1:]); "
          "assert not torch.cuda.is_initialized(); sys.exit(rc)")


def test_fleet_cli_on_the_cpu(tmp_path, capsys):
    """`serve --device cpu` with the fleet's flags and a baseline no
    request can meet, `route` in front of it, then `trace --fleet`,
    `obs`, `history` and `incident` on what they left."""
    rng = np.random.default_rng(3)
    a, ap, b = (rng.random((20, 20, 3)).astype(np.float32)
                for _ in range(3))
    save_image(str(tmp_path / "a.png"), a)
    save_image(str(tmp_path / "ap.png"), ap)
    (tmp_path / "base.json").write_text(json.dumps(
        {"pipeline": {"p99_warm_ms": 0.001}}))
    arch, disc = str(tmp_path / "arch"), str(tmp_path / "fleet.json")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    serve = subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
         "--a", str(tmp_path / "a.png"), "--ap", str(tmp_path / "ap.png"),
         "--device", "cpu", "--port", "0", "--levels", "2",
         "--em-iters", "1", "--pm-iters", "2", "--max-batch", "1",
         "--trace-dir", str(tmp_path / "st"),
         "--state-dir", str(tmp_path / "state"),
         "--lattice", "16:24:1.5", "--warm-dir", str(tmp_path / "warm"),
         "--archive-dir", arch, "--archive-interval-s", "0.2",
         "--obs-interval-s", "0.2", "--baseline",
         str(tmp_path / "base.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    route = None
    try:
        url = _await_live(serve, str(tmp_path / "st"))
        route = subprocess.Popen(
            [sys.executable, "-c", _ROUTE, "route", "--targets", url,
             "--port", "0", "--discovery-out", disc,
             "--trace-dir", str(tmp_path / "rt")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        router_url = _await_live(route, str(tmp_path / "rt"))
        code, doc, hdrs = _post(router_url, _body(b),
                                headers={"X-Request-Id": "cli-1"})
        assert code == 200 and hdrs["X-Routed-To"] == "r0"
        assert doc["cache"] == "hit" and doc["shape"] == [20, 20, 3]
        assert cli_main(["trace", "cli-1", "--fleet", disc,
                         "--format", "json"]) == 0
        joined = json.loads(capsys.readouterr().out)
        # A 20^2 request's HTTP framing is a real share of its wall, so
        # the coverage gate (0.95) is the card's; the join must still
        # be whole: both processes, their rows, an honest gap.
        errs = []
        _validate_joined(joined, "joined", errs, require_coverage=False)
        assert errs == [] and joined["critical_path_coverage"] > 0.5
        assert {r["process"] for r in joined["rows"]} == {"router", "r0"}
        obs_out = str(tmp_path / "obs.json")
        cli_main(["obs", "--targets", disc, "--out", obs_out,
                  "--format", "json"])
        rec = json.loads(open(obs_out).read())
        assert [r["url"] for r in rec["routers"]] == [router_url]
        assert [r["url"] for r in rec["replicas"]] == [url]
        assert rec["fleet"]["route_slo"] is not None
        # Re-merge over the one replica: the pooled SLO holds (the
        # check wants >= 2 replicas and the overhead measurement the
        # chip smoke check takes; nothing else may be violated).
        assert set(validate_obs(rec)) == {
            "replicas: need >= 2 scraped replicas, got 1"}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.listdir(os.path.join(arch, "incidents")):
                break
            time.sleep(0.2)
        route.send_signal(signal.SIGTERM)
        assert route.wait(60) == 0, route.stderr.read()[-2000:]
        serve.send_signal(signal.SIGTERM)
        assert serve.wait(120) == 0
        capsys.readouterr()
        assert cli_main(["history", "--archive-dir", arch,
                         "--format", "json"]) == 0
        hist = json.loads(capsys.readouterr().out)
        assert len(hist["boots"]) == 1 and len(hist["incidents"]) == 1
        assert hist["boots"][0]["final"] is True
        inc = hist["incidents"][0]["id"]
        assert cli_main(["incident", inc, "--archive-dir", arch]) == 0
        assert f"incident {inc}" in capsys.readouterr().out
    finally:
        for p in (route, serve):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(60)

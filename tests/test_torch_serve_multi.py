"""Multi-device serving of the port (`serve --n-devices N`,
serving/ranks.py) on the CPU, with gloo ranks started by
`parallel.mesh.start_world` (this process rank 0, the followers running
tests/torch_serve_workers.py):

  - a 2-rank daemon's answers equal the single-rank port daemon's bit
    for bit: brute and PatchMatch (`pallas_mode="off"`), each at grain 2
    and at grain 4 (2 frames a rank); at 3 ranks and grain 4, the
    padding case;
  - brute through the 2-rank daemon against the JAX daemon on
    `make_mesh(2)` at grain 2, >= 100 dB;
  - warmup of 3 shapes on 3 threads through the channel, then hits;
    a session (solo on rank 0, equal to `VideoStream`) interleaved with
    sessionless dispatches; an idle pause longer than the control
    group's timeout, then a correct answer; `/serving` reports 2
    devices and each rank;
  - faults: one armed on the follower alone heals by the supervisor's
    retry, one on rank 0 alone with no retry left answers 500; the next
    answer is bit-identical either way and the daemon still serves;
  - a follower that dies: an idle one turns /healthz 503 and drains the
    in-process daemon; in `serve --n-devices 2 --device cpu` one
    SIGKILLed during a 4-client burst makes rank 0 answer 503 with
    Retry-After (or 200 for what finished), exit nonzero, and `serve
    --takeover` replays every journaled request, bit-identical, then
    drains with every rank ending 0; one that dies (at the test's
    signal) before it follows fails the serving mesh's start; one lost
    while rank 0's side of the world still forms fails the start and
    leaves no default group, so the next world forms.

24^2-48^2, 2 levels, 1 EM step, torch on one intra-op thread; the data
group's timeout is `T` seconds (a rank whose peer failed waits that long)."""

import base64
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.parallel.mesh import make_mesh as j_make_mesh
from image_analogies_tpu.serving import daemon as j_daemon
from image_analogies_tpu.telemetry import metrics as j_metrics
from image_analogies_tpu_torch import psnr
from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.parallel.mesh import start_world
from image_analogies_tpu_torch.runtime.faults import set_fault_plan
from image_analogies_tpu_torch.serving.accesslog import read_entries
from image_analogies_tpu_torch.serving.daemon import SynthDaemon, _luma_bucket
from image_analogies_tpu_torch.serving.journal import journal_path
from image_analogies_tpu_torch.serving.ranks import ServingMesh, WorldLost
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.utils.io import save_image
from image_analogies_tpu_torch.video.sequence import VideoStream

import torch_serve_workers as wk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 4.0
# What bounds a world's forming here: a spawned rank imports torch first,
# which takes seconds on a loaded machine.
FORM_S = 60.0
BRUTE = dict(levels=2, matcher="brute", em_iters=1)
PM = dict(levels=2, matcher="patchmatch", pallas_mode="off", em_iters=1,
          pm_iters=2)
WARM_SHAPES = ((24, 24, 3), (32, 32, 3), (40, 32, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _body(frame, **extra) -> bytes:
    return json.dumps({
        "image_b64": base64.b64encode(
            np.ascontiguousarray(frame, np.float32).tobytes()).decode(),
        "shape": list(frame.shape), "dtype": "float32", **extra,
    }).encode()


def _post(url, body, rid=None, timeout=300.0):
    """(status, parsed JSON, headers) of one POST /synthesize."""
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(url + "/synthesize", data=body,
                                 method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, timeout=30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image(doc) -> np.ndarray:
    return np.frombuffer(base64.b64decode(doc["image_b64"]),
                         np.float32).reshape(doc["shape"])


def _together(url, bodies):
    """Every body POSTed at once; the answers in order."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = _post(url, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def _inputs(size=32, seed=11):
    """A, A' and three frames: f1 and f2 share a luma bucket (f2 is f1
    mirrored), f3 sits in another."""
    rng = np.random.default_rng(seed)
    a = rng.random((size, size, 3)).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random(a.shape), 0, 1).astype(
        np.float32)
    f1 = rng.random((size, size, 3)).astype(np.float32)
    f2 = np.ascontiguousarray(f1[::-1, ::-1])
    f3 = (0.5 * f1 + 0.25).astype(np.float32)
    assert _luma_bucket(f1) == _luma_bucket(f2) != _luma_bucket(f3)
    return a, ap, [f1, f2, f3]


def _daemon(a, ap, kw, grain, mesh=None, **extra):
    return SynthDaemon(a, ap, SynthConfig(device="cpu", **kw),
                       registry=MetricsRegistry(), max_batch=grain,
                       max_wait_ms=300.0, obs_interval_s=0, mesh=mesh,
                       **extra).start()


def _answers(d, frames):
    """The three frames POSTed together, then f1 alone: images."""
    res = _together(d.url, [_body(f) for f in frames])
    res.append(_post(d.url, _body(frames[0])))
    assert [c for c, _, _ in res] == [200] * len(res), res
    return [_image(r) for _, r, _ in res]


_ARMS = [("brute", BRUTE, 2), ("brute", BRUTE, 4), ("pm", PM, 2),
         ("pm", PM, 4)]


def _warm_frames():
    rng = np.random.default_rng(5)
    return [rng.random(s).astype(np.float32) for s in WARM_SHAPES]


def _clip():
    rng = np.random.default_rng(9)
    return [rng.random((32, 32, 3)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def single():
    """The single-rank port daemon's answers: each arm, the warm shapes
    at PatchMatch grain 2, and the session against `VideoStream`."""
    a, ap, frames = _inputs()
    prev = set_registry(MetricsRegistry())
    out = {}
    try:
        for name, kw, grain in _ARMS:
            d = _daemon(a, ap, kw, grain)
            try:
                out[name, grain] = _answers(d, frames)
            finally:
                d.stop()
        d = _daemon(a, ap, PM, 2)
        try:
            out["warm"] = [_image(_post(d.url, _body(f))[1])
                           for f in _warm_frames()]
        finally:
            d.stop()
    finally:
        set_registry(prev)
    clip = _clip()
    stream = VideoStream(a, ap, cfg=SynthConfig(device="cpu", **PM),
                         b_stats=_luma_bucket(clip[0]))
    out["session"] = [stream.step(f).numpy() for f in clip]
    return out


@pytest.fixture(scope="module")
def two_ranks():
    """One world of two ranks (the follower armed with `level:1:raise`,
    which fires at the world's first dispatch), every scenario in turn;
    the follower is killed last."""
    a, ap, frames = _inputs()
    prev = set_registry(MetricsRegistry())
    out = {}
    followers = start_world(2, wk.follower, args=("level:1:raise",),
                            device_type="cpu")
    mesh = ServingMesh(followers, a, ap, device_type="cpu", timeout_s=T)
    try:
        # Faults: the follower's (healed by the retry), then rank 0's
        # with no retry left (a 500).
        d = _daemon(a, ap, PM, 2, mesh=mesh, max_retries=1)
        try:
            t0 = time.monotonic()
            out["follower_fault"] = _post(d.url, _body(frames[0]))
            out["follower_fault_s"] = time.monotonic() - t0
            out["after_follower_fault"] = _post(d.url, _body(frames[0]))
        finally:
            d.stop()
        d = _daemon(a, ap, PM, 2, mesh=mesh, max_retries=0)
        try:
            set_fault_plan("level:0:raise")
            try:
                out["rank0_fault"] = _post(d.url, _body(frames[0]))
            finally:
                set_fault_plan(None)
            out["after_rank0_fault"] = _post(d.url, _body(frames[0]))
        finally:
            d.stop()
        out["epoch_after_faults"] = mesh.snapshot()["data_group_epoch"]

        for name, kw, grain in _ARMS:
            d = _daemon(a, ap, kw, grain, mesh=mesh)
            try:
                out[name, grain] = _answers(d, frames)
            finally:
                d.stop()

        # JAX's daemon on a mesh of two host devices, at grain 2.
        jd = j_daemon.SynthDaemon(
            a, ap, JCfg(**BRUTE), registry=j_metrics.MetricsRegistry(),
            mesh=j_make_mesh(2), max_batch=2, max_wait_ms=300.0,
            obs_interval_s=0).start()
        try:
            out["jax"] = [_image(r) for _, r, _ in
                          _together(jd.url, [_body(f) for f in frames])]
        finally:
            jd.stop()

        # Warmup, sessions, the idle pause and /serving on one daemon
        # at the default grain (the rank count).
        d = _daemon(a, ap, PM, None, mesh=mesh, warmup_workers=3)
        try:
            out["grain"] = d.policy.max_batch
            out["warmup"] = d.warmup([
                {"height": h, "width": w, "channels": c}
                for h, w, c in WARM_SHAPES])
            out["warm"] = [_post(d.url, _body(f)) for f in _warm_frames()]
            clip = _clip()
            bodies = []
            for i, f in enumerate(clip):
                bodies += [_body(f, session_id="clip-a"),
                           _body(frames[i % 2])]
            session = []
            for i in range(0, len(bodies), 2):
                session.append(_together(d.url, bodies[i:i + 2]))
            out["session"] = session
            time.sleep(2 * T + 1.0)
            out["after_idle"] = _post(d.url, _body(frames[0]))
            out["serving"] = _get(d.url + "/serving")[1]

            # A follower killed while idle.
            os.kill(followers.pids[0], signal.SIGKILL)
            d.drained.wait(30.0)
            out["drained"] = d.drained.is_set()
            out["world_lost"] = d.world_lost
            out["healthz"] = _get(d.url + "/healthz")
            out["after_loss"] = _post(d.url, _body(frames[0]))
            try:
                mesh.run(np.stack([frames[0]] * 2),
                         SynthConfig(device="cpu", **PM))
            except WorldLost as e:
                out["run_after_loss"] = str(e)
        finally:
            d.stop()
    finally:
        out["exit_codes"] = mesh.close()
        set_registry(prev)
    return out


def test_faults_on_one_rank_heal_or_fail_and_the_daemon_serves(
        two_ranks, single):
    ref = single["pm", 2][3]
    code, doc, _ = two_ranks["follower_fault"]
    assert code == 200, doc
    np.testing.assert_array_equal(_image(doc), ref)
    # The heal waited out the data group's timeout once.
    assert T <= two_ranks["follower_fault_s"] < 6 * T
    code, doc, _ = two_ranks["rank0_fault"]
    assert code == 500 and "gave up" in doc["error"]
    for key in ("after_follower_fault", "after_rank0_fault"):
        code, doc, _ = two_ranks[key]
        assert code == 200, doc
        np.testing.assert_array_equal(_image(doc), ref)
    # Each failed attempt moved every rank to a new data group.
    assert two_ranks["epoch_after_faults"] == 2


@pytest.mark.parametrize("name,kw,grain", _ARMS,
                         ids=[f"{n}-grain{g}" for n, _, g in _ARMS])
def test_two_ranks_equal_the_single_rank_daemon(two_ranks, single, name,
                                                kw, grain):
    for got, want in zip(two_ranks[name, grain], single[name, grain]):
        np.testing.assert_array_equal(got, want)


def test_brute_over_two_ranks_against_the_jax_daemon(two_ranks):
    for got, want in zip(two_ranks["brute", 2], two_ranks["jax"]):
        assert psnr(got, want) >= 100.0


def test_warmup_of_three_shapes_through_the_channel(two_ranks, single):
    assert two_ranks["grain"] == 2
    assert len(two_ranks["warmup"]) == len(WARM_SHAPES)
    for (code, doc, _), want in zip(two_ranks["warm"], single["warm"]):
        assert code == 200 and doc["cache"] == "hit", doc
        np.testing.assert_array_equal(_image(doc), want)


def test_a_session_interleaved_with_sessionless_dispatches(two_ranks,
                                                           single):
    for i, pair in enumerate(two_ranks["session"]):
        (sc, sdoc, _), (c, doc, _) = pair
        assert sc == c == 200
        np.testing.assert_array_equal(_image(sdoc), single["session"][i])
        np.testing.assert_array_equal(_image(doc),
                                      single["pm", 2][i % 2])


def test_an_idle_pause_past_the_control_timeout(two_ranks, single):
    code, doc, _ = two_ranks["after_idle"]
    assert code == 200, doc
    np.testing.assert_array_equal(_image(doc), single["pm", 2][3])


def test_serving_reports_the_ranks(two_ranks):
    snap = two_ranks["serving"]
    assert snap["devices"] == 2 and snap["backend"] == "cpu"
    ranks = snap["ranks"]
    assert ranks["size"] == 2 and ranks["backend"] == "gloo"
    assert ranks["lost"] is None and len(ranks["follower_pids"]) == 1
    assert ranks["dispatches"] > 10
    # Kernels run only on the card: no launch on either CPU rank.
    assert ranks["k1_launches"] == [0, 0]


def test_an_idle_follower_killed_drains_the_daemon(two_ranks):
    assert two_ranks["drained"]
    assert "rank 1 exited" in two_ranks["world_lost"]
    code, health = two_ranks["healthz"]
    assert code == 503 and health["verdict"] == "violated"
    assert {c["name"]: c["status"] for c in health["checks"]}[
        "serving_ranks"] == "violated"
    code, doc, headers = two_ranks["after_loss"]
    assert code == 503 and int(headers["Retry-After"]) >= 1
    assert "rank 1 exited" in two_ranks["run_after_loss"]
    assert two_ranks["exit_codes"] == [-signal.SIGKILL]


def test_three_ranks_at_grain_four_pad_the_stack(single):
    """4 frames over 3 ranks: the stack is padded to 6, 2 a rank."""
    a, ap, frames = _inputs()
    prev = set_registry(MetricsRegistry())
    followers = start_world(3, wk.follower, device_type="cpu")
    mesh = ServingMesh(followers, a, ap, device_type="cpu", timeout_s=T)
    try:
        d = _daemon(a, ap, PM, 4, mesh=mesh)
        try:
            got = _answers(d, frames)
        finally:
            d.stop()
    finally:
        codes = mesh.close()
        set_registry(prev)
    assert codes == [0, 0]
    for g, w in zip(got, single["pm", 4]):
        np.testing.assert_array_equal(g, w)


def test_a_follower_dead_before_it_follows_fails_the_start(tmp_path):
    """The follower joins the world and exits (code 3) when the test
    says so, after the world formed and before the mesh starts."""
    a, ap, _ = _inputs(size=24)
    flag = tmp_path / "exit"
    followers = start_world(2, wk.exit_when, args=(str(flag),),
                            device_type="cpu", timeout_s=FORM_S)
    try:
        flag.touch()
        followers.procs[0].join(FORM_S)
        assert followers.dead() == [(1, 3)]
        with pytest.raises(RuntimeError):
            ServingMesh(followers, a, ap, device_type="cpu", timeout_s=T)
    finally:
        codes = followers.join(30.0)
        torch.distributed.destroy_process_group()
    assert codes == [3]


def test_a_follower_lost_while_the_world_forms_leaves_no_group(monkeypatch):
    """Rank 0's forming outlives its follower, which exits as soon as it
    has joined (rank 0's `_init_world` is held open here until the
    follower is gone): the start raises, destroys the default group the
    forming made, and a next world forms in the same process."""
    import multiprocessing

    from image_analogies_tpu_torch.parallel import mesh

    real = mesh._init_world

    def held_open(*args):
        real(*args)
        deadline = time.monotonic() + FORM_S
        while time.monotonic() < deadline and any(
                p.name == "ia-rank-1"
                for p in multiprocessing.active_children()):
            time.sleep(0.02)
        time.sleep(1.0)  # past the guard's next look at its followers

    monkeypatch.setattr(mesh, "_init_world", held_open)
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        start_world(2, wk.exit_at_once, device_type="cpu", timeout_s=FORM_S)
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(mesh, "_init_world", real)
    followers = start_world(2, wk.meet, device_type="cpu", timeout_s=FORM_S)
    try:
        assert torch.distributed.get_world_size() == 2
        torch.distributed.barrier()
    finally:
        codes = followers.join(30.0)
        torch.distributed.destroy_process_group()
    assert codes == [0]
    assert not torch.distributed.is_initialized()


def test_serve_start_stops_clearly_when_a_follower_exits(tmp_path,
                                                        monkeypatch):
    """`serve --n-devices 2 --device cpu` whose follower exits (code 3)
    as soon as it has joined: the command stops with a message naming
    the rank and its code, whichever start step saw it (the world's
    forming or the serving mesh's start)."""
    from image_analogies_tpu_torch import cli
    from image_analogies_tpu_torch.serving import ranks

    rng = np.random.default_rng(2)
    for name in ("A.png", "Ap.png"):
        save_image(str(tmp_path / name), rng.random((24, 24, 3)))
    monkeypatch.setattr(ranks, "follow", wk.exit_at_once)
    try:
        with pytest.raises(SystemExit) as stop:
            cli.main(["serve", "--a", str(tmp_path / "A.png"), "--ap",
                      str(tmp_path / "Ap.png"), "--device", "cpu",
                      "--n-devices", "2", "--port", "0", "--levels", "1"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert re.fullmatch(r"serve: .*rank 1 exited with code 3",
                        str(stop.value.code)), stop.value.code


# ------------------------------------------------ the command line
def _serve(work, tag, *extra, env_extra=None):
    """`serve --n-devices 2 --device cpu` in its own process group:
    (process, url)."""
    td = os.path.join(work, f"{tag}_trace")
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
           "--a", os.path.join(work, "A.png"),
           "--ap", os.path.join(work, "Ap.png"), "--device", "cpu",
           "--n-devices", "2", "--max-batch", "2", "--max-wait-ms", "50",
           "--levels", "2", "--matcher", "patchmatch", "--em-iters", "1",
           "--pm-iters", "2", "--pallas-mode", "off", "--port", "0",
           "--trace-dir", td, "--dispatch-deadline-s", str(T),
           "--state-dir", os.path.join(work, "state"), *extra]
    err = open(os.path.join(work, f"{tag}.err"), "w")
    proc = subprocess.Popen(
        cmd, cwd=ROOT, stdout=err, stderr=subprocess.STDOUT,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env_extra or {})})
    live = os.path.join(td, "live.json")
    deadline = time.monotonic() + 240
    while not os.path.exists(live):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(open(err.name).read()[-3000:])
        time.sleep(0.05)
    with open(live) as f:
        return proc, json.load(f)["url"]


def test_serve_cli_follower_killed_then_takeover(tmp_path):
    work = str(tmp_path)
    rng = np.random.default_rng(21)
    save_image(os.path.join(work, "A.png"), rng.random((48, 48, 3)))
    save_image(os.path.join(work, "Ap.png"), rng.random((48, 48, 3)))
    frames = [rng.random((48, 48, 3)).astype(np.float32) for _ in range(4)]
    proc, url = _serve(work, "d1")
    try:
        refs = [_post(url, _body(f)) for f in frames]
        assert [c for c, _, _ in refs] == [200] * 4
        refs = [hashlib.sha256(np.ascontiguousarray(_image(d)).tobytes())
                .hexdigest() for _, d, _ in refs]
        pid = _get(url + "/serving")[1]["ranks"]["follower_pids"][0]
        results = {}

        def client(i):
            results[i] = _post(url, _body(frames[i]), rid=f"burst-{i}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while _get(url + "/serving")[1]["inflight"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        os.kill(pid, signal.SIGKILL)
        t_kill = time.monotonic()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        answered_s = time.monotonic() - t_kill
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = open(os.path.join(work, "d1.err")).read()
    assert rc != 0 and "lost a rank" in log, log[-3000:]
    assert answered_s < 2 * T
    codes = {i: c for i, (c, _, _) in results.items()}
    assert set(codes.values()) <= {200, 503}, results
    assert 503 in codes.values()
    for i, (c, doc, headers) in results.items():
        if c == 503:
            assert int(headers["Retry-After"]) >= 1
        else:
            assert hashlib.sha256(np.ascontiguousarray(_image(doc))
                                  .tobytes()).hexdigest() == refs[i]
    pending = {e["request_id"] for e in read_entries(
        journal_path(os.path.join(work, "state"))) if e["kind"] == "req"}
    pending -= {e["request_id"] for e in read_entries(
        journal_path(os.path.join(work, "state"))) if e["kind"] == "mark"}
    assert pending and all(codes[int(r.split("-")[1])] == 503
                           for r in pending)
    # Every burst request that was not answered 200 was journaled.
    assert {f"burst-{i}" for i, c in codes.items() if c != 200} <= pending

    proc, url = _serve(work, "d2", "--takeover",
                       os.path.join(work, "state"))
    try:
        deadline = time.monotonic() + 120
        while True:
            journal = _get(url + "/journal")[1]
            if set(journal["replayed"]) >= pending:
                break
            assert time.monotonic() < deadline, journal
            time.sleep(0.05)
        for rid in pending:
            assert journal["replayed"][rid]["sha256"] == \
                refs[int(rid.split("-")[1])]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, open(os.path.join(work, "d2.err")).read()[-3000:]

"""The serving daemon of the port (`image_analogies_tpu_torch/serving/`)
against the JAX package's, on the CPU:

  - unit parity: `coalesce` / `RequestQueue` / `AdmissionController`
    decisions over one scripted sequence of arrivals and clocks,
    `exec_key` / `key_str`, `_luma_bucket` and `_decode_request`, equal
    to the JAX package's on the same inputs;
  - the reference's unit classes (tests/test_serving.py), each against
    the port's module;
  - end to end against a JAX daemon on `make_mesh(1)`, both at grain 3:
    three frames (two in one luma bucket, one in another) through the
    brute matcher, each response >= 100 dB from JAX's; the same through
    PatchMatch on the per-pixel path given JAX's draws, >= 70 dB;
  - isolation: a frame served with two co-tenants equals the same frame
    served alone at the same grain, bit for bit;
  - the reference's daemon and request-tracing cases (hit on a repeat
    shape, give-up -> 500 and the daemon survives, overload sheds with
    Retry-After, the sentinel grades `ok`, one connected span tree per
    request, X-Parent-Span / X-Trace-Hop echoed and recorded, the access
    log covers every outcome, `trace` renders the waterfall within 5 %);
  - sessions: three frames under one session_id equal the port's
    `VideoStream` stepped by hand, bit for bit, with their request ids.

Frames are 24^2-32^2, two levels, one EM step; torch runs on one
intra-op thread."""

import base64
import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from image_analogies_tpu.config import SynthConfig as JCfg  # noqa: E402
from image_analogies_tpu.parallel.mesh import make_mesh  # noqa: E402
from image_analogies_tpu.serving import daemon as j_daemon  # noqa: E402
from image_analogies_tpu.serving import excache as j_ex  # noqa: E402
from image_analogies_tpu.serving import queueing as j_q  # noqa: E402
from image_analogies_tpu.telemetry import metrics as j_metrics  # noqa: E402
from image_analogies_tpu_torch import psnr  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving import daemon as t_daemon  # noqa: E402
from image_analogies_tpu_torch.serving import queueing as t_q  # noqa: E402
from image_analogies_tpu_torch.serving.daemon import (  # noqa: E402
    SynthDaemon,
    _decode_request,
    _luma_bucket,
)
from image_analogies_tpu_torch.serving.excache import (  # noqa: E402
    ExecutableCache,
    compression_mode,
    config_fingerprint,
    exec_key,
    key_str,
    load_warmup_manifest,
    run_warmup,
)
from image_analogies_tpu_torch.serving.queueing import (  # noqa: E402
    AdmissionController,
    BatchingPolicy,
    RequestQueue,
    ServeRequest,
    coalesce,
    demux,
    head_deadline,
)
from image_analogies_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.sentinel import (  # noqa: E402
    IMBALANCE_RATIO_MAX,
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


def _body(frame: np.ndarray, **extra) -> bytes:
    return json.dumps({
        "image_b64": base64.b64encode(
            np.ascontiguousarray(frame.astype(np.float32)).tobytes()
        ).decode(),
        "shape": list(frame.shape),
        "dtype": "float32",
        **extra,
    }).encode()


def _post(url: str, body: bytes, timeout: float = 300.0,
          headers=None):
    """(status, parsed-json, headers) for POST /synthesize."""
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(
        url + "/synthesize", data=body, method="POST", headers=hdrs,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(
                resp.headers
            )
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def _image(resp: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(resp["image_b64"]), np.float32
    ).reshape(resp["shape"])


def _post_together(url, bodies):
    """POST every body at once (one thread each); responses in order."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = _post(url, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


# ------------------------------------------------------ unit parity
_YOUNG = -3.6e6  # enqueued "an hour from now": never ages out here


def _script():
    """(compat label, age in ms) arrivals: heads aged far past the
    policy's wait or never aging in the test, so no decision races the
    clock."""
    return [("a", 900.0), ("b", 800.0), ("a", 700.0), ("c", _YOUNG),
            ("a", _YOUNG), ("b", _YOUNG), ("c", _YOUNG), ("c", _YOUNG)]


def _requests(mod, now):
    return [
        mod.ServeRequest(frame=None, key=("k",), compat=c, b_stats=None,
                         enqueue_t=now - age / 1000.0)
        for c, age in _script()
    ]


@pytest.mark.parametrize("max_batch,max_wait_ms", [
    (1, 25.0), (2, 25.0), (3, 25.0), (3, 1e6),
])
def test_policy_decisions_equal_jax(max_batch, max_wait_ms):
    """coalesce and head_deadline step by step over the scripted queue,
    and RequestQueue.next_batch draining it: the same batches (by
    arrival index) and deadlines in both packages."""
    now = time.monotonic()
    decisions = []
    for mod in (j_q, t_q):
        policy = mod.BatchingPolicy(max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)
        reqs = _requests(mod, now)
        index = {id(r): i for i, r in enumerate(reqs)}
        left, steps = list(reqs), []
        while left:
            batch = mod.coalesce(left, now, policy)
            steps.append((
                mod.head_deadline(left, policy) - now,
                None if batch is None else [index[id(r)] for r in batch],
            ))
            if batch is None:
                left = left[1:]  # the head ages out of the script
            else:
                gone = {id(r) for r in batch}
                left = [r for r in left if id(r) not in gone]
        q = mod.RequestQueue()
        for r in _requests(mod, now):
            q.put(r)
        popped = []
        while True:
            batch = q.next_batch(policy, timeout=0.02)
            if batch is None:
                break
            popped.append([r.compat for r in batch])
        decisions.append((steps, popped, len(q)))
    j, t = decisions
    assert [s[1] for s in t[0]] == [s[1] for s in j[0]]
    np.testing.assert_allclose([s[0] for s in t[0]],
                               [s[0] for s in j[0]], rtol=0, atol=1e-9)
    assert t[1:] == j[1:]


def _admission_pair(p50_ms, degraded=False, ladder=False):
    out = []
    for reg in (j_metrics.MetricsRegistry(), MetricsRegistry()):
        h = reg.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        )
        for _ in range(5):
            h.observe(p50_ms, labels={"phase": "service"})
        if degraded:
            reg.gauge("ia_shard_imbalance_ratio", "straggler").set(
                IMBALANCE_RATIO_MAX * 2)
        if ladder:
            reg.counter("ia_degradations_total", "ladder").inc(
                labels={"action": "polish_stream"})
        out.append(reg)
    return (j_q.AdmissionController(max_depth=8, registry=out[0]),
            AdmissionController(max_depth=8, registry=out[1]))


@pytest.mark.parametrize("p50_ms,degraded,ladder", [
    (0.0, False, False), (40.0, False, False), (2500.0, False, False),
    (300.0, True, False), (300.0, False, True),
])
def test_admission_decisions_equal_jax(p50_ms, degraded, ladder):
    """admit / retry_after / deadline_permits / effective_depth over a
    grid of backlogs and deadlines at one fixed clock."""
    jac, tac = _admission_pair(p50_ms, degraded, ladder)
    now = 1000.0
    grid = [(d, i) for d in range(0, 10, 3) for i in range(0, 4)]
    for ac_j, ac_t in ((jac, tac),):
        assert ac_t.effective_depth() == ac_j.effective_depth()
        assert ac_t.backend_degraded() == ac_j.backend_degraded()
        assert ac_t.service_p50_s() == ac_j.service_p50_s()
        for d, i in grid:
            assert ac_t.admit(d, i) == ac_j.admit(d, i), (d, i)
            assert ac_t.retry_after(d + i) == ac_j.retry_after(d + i)
            for dl in (None, now - 0.1, now + 0.05, now + 2.0, now + 60):
                assert ac_t.deadline_permits(dl, d, i, now=now) == \
                    ac_j.deadline_permits(dl, d, i, now=now), (dl, d, i)


@pytest.mark.parametrize("shape,batch", [
    ((32, 32, 3), 1), ((24, 40, 3), 4), ((64, 48), 2),
])
def test_exec_key_equal_jax(shape, batch):
    """The key's shape, config fingerprint and matcher equal JAX's; its
    compression label is JAX's without the packed-layout field."""
    import dataclasses

    for kw in (_SERVE_CFG, dict(levels=3, matcher="brute", kappa=2.0)):
        jk = j_ex.exec_key(shape, JCfg(**kw), batch)
        for cfg in (SynthConfig(**kw), SynthConfig(device="cpu", **kw),
                    dataclasses.replace(SynthConfig(**kw),
                                        save_level_artifacts="/x")):
            tk = exec_key(shape, cfg, batch)
            assert tk[:3] == jk[:3]
            assert tk[3] == "|".join(jk[3].split("|")[:2])
            assert key_str(tk) == key_str(jk).replace(
                "|" + jk[3].split("|")[2], "")


def _bodies():
    rng = np.random.default_rng(3)
    f = rng.random((8, 6, 3)).astype(np.float32)
    u8 = (rng.random((8, 6, 3)) * 255).astype(np.uint8)
    one = rng.random((8, 6, 1)).astype(np.float32)
    return [
        _body(f), _body(0.5 * f + 0.25), _body(one),
        json.dumps({"image_b64": base64.b64encode(u8.tobytes()).decode(),
                    "shape": [8, 6, 3], "dtype": "uint8"}).encode(),
        _body(np.full((8, 8, 3), 0.5, np.float32)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_decode_and_luma_bucket_equal_jax(i):
    body = _bodies()[i]
    jf = j_daemon._decode_request(body)
    tf = _decode_request(body)
    assert tf.dtype == jf.dtype and tf.shape == jf.shape
    np.testing.assert_array_equal(tf, jf)
    assert _luma_bucket(tf) == tuple(float(v) for v in
                                     j_daemon._luma_bucket(jf))


# ------------------------------------------------- executable cache
class TestExecKey:
    def test_fingerprint_ignores_noncompute_fields(self, tmp_path):
        import dataclasses

        cfg = SynthConfig(**_SERVE_CFG)
        with_ckpt = dataclasses.replace(
            cfg, save_level_artifacts=str(tmp_path)
        )
        assert config_fingerprint(cfg) == config_fingerprint(with_ckpt)

    def test_fingerprint_tracks_compute_fields(self):
        import dataclasses

        cfg = SynthConfig(**_SERVE_CFG)
        assert config_fingerprint(cfg) != config_fingerprint(
            dataclasses.replace(cfg, em_iters=cfg.em_iters + 1)
        )

    def test_key_carries_batch_shape_matcher_compression(self):
        cfg = SynthConfig(**_SERVE_CFG)
        k1 = exec_key((32, 32, 3), cfg, batch_size=2)
        assert k1[0] == (2, 32, 32, 3)
        assert k1[2] == cfg.matcher
        # Compression mode is the two process-wide kernel knobs (the
        # reference's third, the TPU's packed layout, has no twin).
        assert len(k1[3].split("|")) == 2
        assert k1[3] == compression_mode()
        assert exec_key((32, 32, 3), cfg, batch_size=4) != k1
        assert exec_key((64, 64, 3), cfg, batch_size=2) != k1
        assert "32" in key_str(k1) and cfg.matcher in key_str(k1)


class TestExecutableCache:
    def _hits(self, reg, kind="client"):
        return reg.to_dict().get(
            "ia_serve_excache_hits_total", {}
        ).get("values", {}).get('{kind="%s"}' % kind, 0)

    def _misses(self, reg, kind="client"):
        return reg.to_dict().get(
            "ia_serve_excache_misses_total", {}
        ).get("values", {}).get('{kind="%s"}' % kind, 0)

    def test_miss_then_hit_books_counters(self):
        reg = MetricsRegistry()
        cache = ExecutableCache(capacity=2, registry=reg)
        key = ((1, 32, 32, 3), "fp", "patchmatch", "bf16|full")
        assert cache.lookup(key) == "miss"
        assert cache.lookup(key) == "hit"
        assert cache.lookup(key) == "hit"
        assert self._misses(reg) == 1 and self._hits(reg) == 2
        snap = cache.snapshot()
        assert snap["resident"] == 1 and snap["evictions"] == 0
        (entry,) = snap["entries"]
        assert entry["warm"] and entry["hits"] == 2
        assert entry["compiles"] == 1

    def test_warmup_kind_labels_stay_separate(self):
        reg = MetricsRegistry()
        cache = ExecutableCache(capacity=2, registry=reg)
        key = ((1, 16, 16, 3), "fp", "patchmatch", "m")
        cache.lookup(key, kind="warmup")
        cache.lookup(key, kind="client")
        assert self._misses(reg, "warmup") == 1
        assert self._hits(reg, "client") == 1
        assert self._hits(reg, "warmup") == 0

    def test_epoch_eviction_demotes_every_resident(self, monkeypatch):
        # Patch out the real per-shape clear: the unit test asserts the
        # ACCOUNTING epoch semantics.
        import image_analogies_tpu_torch.kernels.patchmatch_tile as pt

        cleared = []
        monkeypatch.setattr(
            pt, "clear_first_use_caches", lambda: cleared.append(1),
        )
        reg = MetricsRegistry()
        cache = ExecutableCache(capacity=2, registry=reg)
        k = [((1, s, s, 3), "fp", "patchmatch", "m") for s in
             (16, 32, 64)]
        cache.lookup(k[0])
        cache.lookup(k[1])
        cache.lookup(k[2])  # evicts k[0] (LRU), demotes k[1]
        assert cleared == [1]
        assert cache.evictions == 1
        evictions = reg.to_dict()[
            "ia_serve_excache_evictions_total"
        ]["values"]["total"]
        assert evictions == 1
        # The demoted survivor re-warms as an HONEST miss.
        assert cache.lookup(k[1]) == "miss"
        assert cache.lookup(k[1]) == "hit"
        # The evicted key was dropped entirely: re-admit, miss.
        assert cache.lookup(k[0]) == "miss"

    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            ExecutableCache(capacity=0)


class TestWarmupManifest:
    def _write(self, tmp_path, manifest):
        p = tmp_path / "warm.json"
        p.write_text(json.dumps(manifest))
        return str(p)

    def test_valid_manifest_loads(self, tmp_path):
        path = self._write(tmp_path, {
            "schema_version": 1, "kind": "serve_warmup",
            "entries": [{"height": 64, "width": 48},
                        {"height": 32, "width": 32, "channels": 1}],
        })
        entries = load_warmup_manifest(path)
        assert entries == [
            {"height": 64, "width": 48, "channels": 3},
            {"height": 32, "width": 32, "channels": 1},
        ]

    @pytest.mark.parametrize("mutation", [
        {"schema_version": 2},
        {"kind": "warmup"},
        {"entries": []},
        {"entries": [{"height": 64}]},
        {"entries": [{"height": 4, "width": 64}]},
        {"entries": [{"height": 64, "width": 64, "channels": 2}]},
    ])
    def test_malformed_manifest_raises(self, tmp_path, mutation):
        manifest = {
            "schema_version": 1, "kind": "serve_warmup",
            "entries": [{"height": 64, "width": 64}],
        }
        manifest.update(mutation)
        with pytest.raises(ValueError):
            load_warmup_manifest(self._write(tmp_path, manifest))

    def test_run_warmup_dedups_by_key_and_records_wall(self):
        cache = ExecutableCache(capacity=4, registry=MetricsRegistry())
        dispatched = []

        def dispatch(shape):
            key = (shape, "fp", "m", "c")
            cache.lookup(key, kind="warmup")
            dispatched.append(shape)

        entries = [
            {"height": 32, "width": 32, "channels": 3},
            {"height": 32, "width": 32, "channels": 3},  # duplicate
            {"height": 16, "width": 16, "channels": 3},
        ]
        report = run_warmup(
            entries, dispatch, cache,
            key_fn=lambda shape: (shape, "fp", "m", "c"),
        )
        assert dispatched == [(32, 32, 3), (16, 16, 3)]
        assert len(report) == 2
        assert all(r["wall_ms"] >= 0 for r in report)
        snap = {e["key"]: e for e in cache.snapshot()["entries"]}
        assert all(e["compile_ms"] is not None for e in snap.values())


# ------------------------------------------- batching + admission
def _req(compat="k", age_ms=0.0):
    r = ServeRequest(frame=None, key=("k",), compat=compat,
                     b_stats=None)
    r.enqueue_t = time.monotonic() - age_ms / 1000.0
    return r


class TestBatchingPolicy:
    def test_policy_validated(self):
        with pytest.raises(ValueError):
            BatchingPolicy(max_batch=0)
        with pytest.raises(ValueError):
            BatchingPolicy(max_wait_ms=-1.0)

    def test_young_partial_batch_waits(self):
        policy = BatchingPolicy(max_batch=2, max_wait_ms=50.0)
        assert coalesce([_req(age_ms=1)], time.monotonic(),
                        policy) is None

    def test_full_batch_flushes_immediately(self):
        policy = BatchingPolicy(max_batch=2, max_wait_ms=1e9)
        batch = coalesce([_req(), _req()], time.monotonic(), policy)
        assert batch is not None and len(batch) == 2

    def test_aged_head_flushes_partial(self):
        policy = BatchingPolicy(max_batch=4, max_wait_ms=50.0)
        batch = coalesce([_req(age_ms=60)], time.monotonic(), policy)
        assert batch is not None and len(batch) == 1

    def test_incompatible_requests_stay_behind(self):
        policy = BatchingPolicy(max_batch=3, max_wait_ms=50.0)
        a1, b1, a2 = _req("a", 60), _req("b", 55), _req("a", 50)
        batch = coalesce([a1, b1, a2], time.monotonic(), policy)
        assert batch == [a1, a2]  # compat-matched, FIFO, b skipped

    def test_head_deadline_tracks_head(self):
        policy = BatchingPolicy(max_batch=4, max_wait_ms=50.0)
        assert head_deadline([], policy) is None
        head = _req(age_ms=10)
        dl = head_deadline([head, _req()], policy)
        assert dl == pytest.approx(head.enqueue_t + 0.05)


class TestRequestQueue:
    def test_next_batch_pops_compat_leaves_rest(self):
        policy = BatchingPolicy(max_batch=2, max_wait_ms=10.0)
        q = RequestQueue()
        a1, a2, b1 = _req("a", 50), _req("a", 40), _req("b", 30)
        for r in (a1, a2, b1):
            q.put(r)
        assert q.next_batch(policy, timeout=1.0) == [a1, a2]
        assert len(q) == 1
        assert q.next_batch(policy, timeout=1.0) == [b1]

    def test_timeout_returns_none(self):
        q = RequestQueue()
        t0 = time.monotonic()
        assert q.next_batch(
            BatchingPolicy(), timeout=0.05
        ) is None
        assert time.monotonic() - t0 < 2.0

    def test_drain_empties(self):
        q = RequestQueue()
        q.put(_req())
        q.put(_req())
        assert len(q.drain()) == 2 and len(q) == 0


class TestAdmissionController:
    def test_admits_below_limit_sheds_at_limit(self):
        adm = AdmissionController(
            max_depth=4, registry=MetricsRegistry()
        )
        assert adm.admit(3, 0) == (True, None)
        ok, retry = adm.admit(3, 1)  # in-flight counts as backlog
        assert not ok and 1.0 <= retry <= 60.0
        ok, _ = adm.admit(0, 4)
        assert not ok

    def test_retry_after_clamped(self):
        reg = MetricsRegistry()
        adm = AdmissionController(max_depth=4, registry=reg)
        # No latency observed yet: floor clamp.
        assert adm.retry_after(100) == 1.0
        h = reg.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        )
        for _ in range(8):
            h.observe(2000.0, labels={"phase": "service"})
        assert adm.retry_after(1000) == 60.0  # ceiling clamp
        assert adm.retry_after(1) >= 1.0

    def test_retry_after_clamp_boundaries(self):
        """Round-15 satellite: the exact clamp edges.  Zero backlog
        prices as ONE queued service time (the shed request itself
        still has to run somewhere), the estimate is monotone in
        backlog between the clamps, and a sub-second estimate rides
        the 1 s floor rather than telling clients to hammer."""
        reg = MetricsRegistry()
        adm = AdmissionController(max_depth=4, registry=reg)
        h = reg.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        )
        for _ in range(8):
            h.observe(2000.0, labels={"phase": "service"})
        assert adm.retry_after(0) == adm.retry_after(1)
        assert adm.retry_after(0) >= 1.0
        assert adm.retry_after(4) <= adm.retry_after(16) <= 60.0
        assert adm.retry_after(10**6) == 60.0
        # Fast backend: 100 ms p50 estimates under a second -> floor.
        reg2 = MetricsRegistry()
        adm2 = AdmissionController(max_depth=4, registry=reg2)
        h2 = reg2.histogram(
            "ia_serve_request_ms",
            "serving request latency by lifecycle phase (ms)",
        )
        for _ in range(8):
            h2.observe(100.0, labels={"phase": "service"})
        assert adm2.retry_after(0) == 1.0

    def test_degraded_backend_halves_depth(self):
        reg = MetricsRegistry()
        adm = AdmissionController(max_depth=8, registry=reg)
        assert adm.effective_depth() == 8
        reg.gauge(
            "ia_shard_imbalance_ratio", "straggler gauge"
        ).set(IMBALANCE_RATIO_MAX * 2)
        assert adm.backend_degraded()
        assert adm.effective_depth() == 4
        ok, _ = adm.admit(4, 0)
        assert not ok

    def test_degradation_counter_also_degrades(self):
        reg = MetricsRegistry()
        adm = AdmissionController(max_depth=8, registry=reg)
        reg.counter(
            "ia_degradations_total", "ladder bookings"
        ).inc(labels={"action": "pallas_off"})
        assert adm.backend_degraded()

    def test_max_depth_validated(self):
        with pytest.raises(ValueError):
            AdmissionController(max_depth=0)


class TestDemux:
    def test_positional_fanout(self):
        batch = [_req("a"), _req("a"), _req("a")]
        stacked = np.arange(4 * 2 * 2, dtype=np.float32).reshape(
            4, 2, 2
        )  # includes one padding row
        demux(batch, stacked[:3])
        for i, r in enumerate(batch):
            assert np.array_equal(r.result, stacked[i])
            assert r.status == "ok"
            assert r.spans[-1]["name"] == "demuxed"

    def test_short_stack_raises(self):
        with pytest.raises(ValueError):
            demux([_req(), _req()], np.zeros((1, 2, 2)))


# ---------------------------------------------------- wire format
class TestDecodeRequest:
    def test_float32_roundtrip(self):
        frame = np.random.default_rng(0).random(
            (8, 6, 3)
        ).astype(np.float32)
        out = _decode_request(_body(frame))
        assert out.dtype == np.float32
        assert np.array_equal(out, frame)

    def test_uint8_scaled(self):
        frame = np.arange(8 * 6 * 3, dtype=np.uint8).reshape(8, 6, 3)
        body = json.dumps({
            "image_b64": base64.b64encode(frame.tobytes()).decode(),
            "shape": [8, 6, 3], "dtype": "uint8",
        }).encode()
        out = _decode_request(body)
        assert out.dtype == np.float32
        assert out.max() <= 1.0
        assert np.allclose(out, frame.astype(np.float32) / 255.0)

    def test_single_channel_squeezes(self):
        frame = np.zeros((8, 6, 1), np.float32)
        body = json.dumps({
            "image_b64": base64.b64encode(frame.tobytes()).decode(),
            "shape": [8, 6, 1], "dtype": "float32",
        }).encode()
        assert _decode_request(body).shape == (8, 6)

    @pytest.mark.parametrize("body", [
        None,
        b"",
        b"not json",
        b'["not", "an", "object"]',
        json.dumps({"image_b64": "AA==", "shape": [8, 6],
                    "dtype": "float32"}).encode(),
        json.dumps({"image_b64": "AA==", "shape": [8, 6, 2],
                    "dtype": "float32"}).encode(),
        json.dumps({"image_b64": "AA==", "shape": [8, 6, 3],
                    "dtype": "float64"}).encode(),
        json.dumps({"shape": [8, 6, 3],
                    "dtype": "float32"}).encode(),
        json.dumps({"image_b64": "!!notb64!!", "shape": [8, 6, 3],
                    "dtype": "float32"}).encode(),
        json.dumps({"image_b64": "AA==", "shape": [8, 6, 3],
                    "dtype": "float32"}).encode(),  # wrong byte count
    ])
    def test_malformed_payloads_raise(self, body):
        with pytest.raises(ValueError):
            _decode_request(body)

    def test_luma_bucket_quantizes_to_centers(self):
        frame = np.full((8, 8, 3), 0.5, np.float32)
        mu, sigma = _luma_bucket(frame)
        assert mu == (np.floor(0.5 * 32) + 0.5) / 32
        assert sigma == 0.5 / 32  # zero std -> first bucket's center




# ------------------------------------------------- against JAX, e2e
def _pair_frames(size=32):
    """f1 and f2 share one luma bucket (f2 is f1 mirrored: the same
    statistics), f3 sits in another; all different content."""
    rng = np.random.default_rng(11)
    a = rng.random((size, size, 3)).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random(a.shape), 0, 1).astype(
        np.float32)
    f1 = rng.random((size, size, 3)).astype(np.float32)
    f2 = np.ascontiguousarray(f1[::-1, ::-1])
    f3 = (0.5 * f1 + 0.25).astype(np.float32)
    assert _luma_bucket(f1) == _luma_bucket(f2) != _luma_bucket(f3)
    return a, ap, [f1, f2, f3]


def _serve_both(kw, frames, a, ap, port_patch=None, extra=None):
    """The three frames POSTed at once to a JAX daemon and to a port
    daemon, both at grain 3; `extra(url)` runs more traffic against the
    port daemon before it stops."""
    bodies = [_body(f) for f in frames]
    out = {}
    jreg = j_metrics.MetricsRegistry()
    jd = j_daemon.SynthDaemon(
        a, ap, JCfg(**kw), registry=jreg, mesh=make_mesh(1),
        max_batch=3, max_wait_ms=400.0, obs_interval_s=0,
    ).start()
    try:
        out["jax"] = _post_together(jd.url, bodies)
    finally:
        jd.stop()
    treg = MetricsRegistry()
    prev = set_registry(treg)
    mp = pytest.MonkeyPatch()
    try:
        if port_patch is not None:
            port_patch(mp)
        td = SynthDaemon(
            a, ap, SynthConfig(device="cpu", **kw), registry=treg,
            max_batch=3, max_wait_ms=400.0, obs_interval_s=0,
        ).start()
        try:
            out["port"] = _post_together(td.url, bodies)
            if extra is not None:
                out.update(extra(td.url))
        finally:
            td.stop()
    finally:
        mp.undo()
        set_registry(prev)
    return out


BRUTE = dict(levels=2, matcher="brute", em_iters=1)


@pytest.fixture(scope="module")
def brute_pair():
    a, ap, frames = _pair_frames()
    return _serve_both(BRUTE, frames, a, ap)


def test_brute_responses_against_jax(brute_pair):
    for i, ((jc, jr, _), (tc, tr, _)) in enumerate(
            zip(brute_pair["jax"], brute_pair["port"])):
        assert jc == tc == 200, (i, jr, tr)
        assert tr["shape"] == jr["shape"]
        assert psnr(_image(tr), _image(jr)) >= 100.0, i
    # f1 and f2 share a bucket: one dispatch of two, f3 alone.
    sizes = [r["batch_size"] for _, r, _ in brute_pair["port"]]
    assert sizes == [r["batch_size"] for _, r, _ in brute_pair["jax"]]


def _jax_draws(mp):
    """The port's per-pixel draws replaced by JAX's per-frame ones (the
    daemon's frame index is always 0), as test_torch_batch.py does."""
    import jax

    from image_analogies_tpu.models import patchmatch as j_pm
    from image_analogies_tpu_torch.models import analogy as t_an

    from test_torch_batch import _JaxFrameDraws
    from test_torch_tile import T

    def init_key(seed, level, device, frame=None):
        level_key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
        return jax.random.fold_in(jax.random.fold_in(level_key, 0x1217),
                                  frame)

    def random_init(key, h, w, ha, wa):
        return T(np.array(j_pm.random_init(key, h, w, ha, wa))).long()

    mp.setattr(t_an, "SweepDraws", _JaxFrameDraws)
    mp.setattr(t_an, "init_generator", init_key)
    mp.setattr(t_an, "random_init", random_init)


@pytest.fixture(scope="module")
def pm_pair():
    a, ap, frames = _pair_frames()
    f1 = frames[0]
    rng = np.random.default_rng(12)
    # Co-tenants of f1 in its own bucket: f1's pixels permuted.
    mates = [f1.reshape(-1, 3)[rng.permutation(f1.shape[0] ** 2)]
             .reshape(f1.shape) for _ in range(2)]

    def extra(url):
        return {
            "trio": _post_together(url, [_body(f) for f in [f1] + mates]),
            "solo": _post(url, _body(f1)),
        }

    return _serve_both(dict(_SERVE_CFG, pm_iters=3), frames, a, ap,
                       port_patch=_jax_draws, extra=extra)


def test_patchmatch_responses_given_jax_draws(pm_pair):
    for i, ((jc, jr, _), (tc, tr, _)) in enumerate(
            zip(pm_pair["jax"], pm_pair["port"])):
        assert jc == tc == 200, (i, jr, tr)
        assert psnr(_image(tr), _image(jr)) >= 70.0, i


def test_co_tenants_change_nothing(pm_pair):
    """f1 with two co-tenants, f1 with one (f2), and f1 alone: one
    answer, bit for bit (each dispatch padded to grain 3)."""
    trio = pm_pair["trio"]
    assert [c for c, _, _ in trio] == [200, 200, 200]
    assert [r["batch_size"] for _, r, _ in trio] == [3, 3, 3]
    code, solo, _ = pm_pair["solo"]
    assert code == 200 and solo["batch_size"] == 1
    np.testing.assert_array_equal(_image(trio[0][1]), _image(solo))
    np.testing.assert_array_equal(_image(pm_pair["port"][0][1]),
                                  _image(solo))


# ------------------------------------------------- daemon end-to-end
@pytest.fixture(scope="module")
def daemon_scenario(tmp_path_factory):
    """One in-process port daemon on the CPU, wired as cli.cmd_serve
    wires it (a Tracer, a FlightRecorder observer, an access log in a
    trace dir that outlives stop()): cold and warm requests, a malformed
    body, a hostile request id, an injected give-up, an overload burst,
    and three frames of one session."""
    from image_analogies_tpu_torch.runtime.faults import set_fault_plan
    from image_analogies_tpu_torch.serving.accesslog import read_entries
    from image_analogies_tpu_torch.telemetry.flight import FlightRecorder
    from image_analogies_tpu_torch.telemetry.spans import Tracer

    trace_dir = str(tmp_path_factory.mktemp("serve-trace"))
    rng = np.random.default_rng(7)
    a, ap, b = (
        rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)
    )
    clip = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)]
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    tracer = Tracer(registry=reg)
    flight = FlightRecorder(
        tracer, reg, os.path.join(trace_dir, "flight.json"),
        capacity=4096,
    )
    tracer.add_observer(flight.observe)
    daemon = SynthDaemon(
        a, ap, cfg, registry=reg, tracer=tracer, flight=flight,
        max_batch=1, max_wait_ms=5.0, max_queue_depth=2,
        cache_capacity=4, max_retries=1,
        access_log_path=os.path.join(trace_dir, "access.jsonl"),
    ).start()
    body = _body(b)
    out = {"trace_dir": trace_dir, "tracer": tracer}
    try:
        out["cold"] = _post(daemon.url, body)
        out["warm"] = _post(
            daemon.url, body, headers={"X-Request-Id": "pin-req-1"}
        )
        from image_analogies_tpu_torch.parallel.batch import (
            synthesize_batch,
        )

        out["solo_ref"] = synthesize_batch(
            a, ap, b[None], cfg, frame_indices=[0],
            _b_stats=daemon._make_request(b).b_stats,
        )[0].numpy()
        out["serving"] = json.loads(_get(daemon.url + "/serving")[1])
        out["metrics_text"] = _get(daemon.url + "/metrics")[1].decode()
        out["health_mid"] = daemon.health()

        out["traced"] = _post(daemon.url, body, headers={
            "X-Request-Id": "hop-req-1", "X-Parent-Span": "router-span-7",
            "X-Trace-Hop": "2"})
        out["bad_parent"] = _post(daemon.url, body, headers={
            "X-Parent-Span": "no spaces allowed!", "X-Trace-Hop": "x"})
        out["bad"] = _post(daemon.url, b"not json")
        out["bad_rid"] = _post(
            daemon.url, body,
            headers={"X-Request-Id": "bad id with spaces!"},
        )

        set_fault_plan("level:0:raise:2")  # outlives max_retries=1
        out["gave_up"] = _post(daemon.url, body)
        out["after_give_up"] = _post(daemon.url, body)

        set_fault_plan("level:0:hang:3")  # slow one dispatch 3 s
        results = []
        lock = threading.Lock()

        def worker():
            r = _post(daemon.url, body)
            with lock:
                results.append(r)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=300)
        out["burst"] = results
        set_fault_plan(None)

        out["session"] = [
            _post(daemon.url, _body(f, session_id="clip-a"),
                  headers={"X-Request-Id": f"clip-{i}"})
            for i, f in enumerate(clip)
        ]
        out["session_ids"] = list(daemon._sessions["clip-a"].request_ids)
        out["health_end"] = daemon.health()
        out["slo"] = json.loads(_get(daemon.url + "/slo")[1])
    finally:
        set_fault_plan(None)
        daemon.stop()
        set_registry(prev)
    from image_analogies_tpu_torch.video.sequence import VideoStream

    stream = VideoStream(a, ap, cfg=cfg, b_stats=_luma_bucket(clip[0]))
    out["session_ref"] = [stream.step(f).numpy() for f in clip]
    flight.flush("manual")  # <trace_dir>/flight.json for `trace`
    out["flight"] = flight.to_dict("manual")
    out["access"] = list(
        read_entries(os.path.join(trace_dir, "access.jsonl"))
    )
    return out


class TestDaemonEndToEnd:
    def test_repeat_shape_is_cache_hit(self, daemon_scenario):
        code, r, _ = daemon_scenario["cold"]
        assert code == 200 and r["cache"] == "miss"
        code, r, _ = daemon_scenario["warm"]
        assert code == 200 and r["cache"] == "hit"
        assert [s["name"] for s in r["spans"]] == [
            "queued", "admitted", "cache-hit", "executed", "demuxed",
        ]

    def test_response_image_roundtrips(self, daemon_scenario):
        _, r, _ = daemon_scenario["warm"]
        img = _image(r)
        assert img.shape == (24, 24, 3)
        assert np.all(np.isfinite(img))

    def test_output_matches_solo_dispatch(self, daemon_scenario):
        """Isolation contract: the served answer is bit-identical to a
        direct solo `synthesize_batch` call for the same frame."""
        _, r, _ = daemon_scenario["warm"]
        np.testing.assert_array_equal(
            _image(r), daemon_scenario["solo_ref"]
        )

    def test_serving_snapshot_shape(self, daemon_scenario):
        snap = daemon_scenario["serving"]
        assert snap["cache"]["resident"] == 1
        assert snap["policy"]["max_batch"] == 1
        assert set(snap["slo_ms"]) == {"queued", "service", "total"}
        assert snap["slo_ms"]["total"]["p50"] is not None
        assert snap["disk_cache"] is None and snap["lattice"] is None

    def test_metrics_exposition_carries_serving_families(
        self, daemon_scenario
    ):
        text = daemon_scenario["metrics_text"]
        assert 'ia_serve_excache_hits_total{kind="client"} 1' in text
        assert "ia_serve_requests_total 2" in text
        assert "ia_serve_request_ms" in text

    def test_give_up_maps_to_500_daemon_survives(self, daemon_scenario):
        code, r, _ = daemon_scenario["gave_up"]
        assert code == 500 and "gave up" in r["error"]
        code, r, _ = daemon_scenario["after_give_up"]
        assert code == 200 and r["status"] == "ok"

    def test_overload_sheds_with_retry_after(self, daemon_scenario):
        codes = sorted(c for c, _, _ in daemon_scenario["burst"])
        assert 429 in codes and 200 in codes
        shed = next(
            (r, h) for c, r, h in daemon_scenario["burst"] if c == 429
        )
        r, headers = shed
        assert r["status"] == "shed"
        assert int(headers["Retry-After"]) >= 1
        assert r["retry_after_s"] >= 1.0

    def test_sentinel_grades_the_session(self, daemon_scenario):
        for key in ("health_mid", "health_end"):
            checks = {
                c["name"]: c for c in daemon_scenario[key]["checks"]
            }
            assert checks["serving"]["status"] == "ok", checks[
                "serving"
            ]
            assert checks["recovery"]["status"] == "ok", checks[
                "recovery"
            ]
        observed = {
            c["name"]: c for c in daemon_scenario["health_end"][
                "checks"
            ]
        }["serving"]["observed"]
        assert observed["requests"] == (
            observed["admitted"] + observed["shed"]
        )
        assert observed["shed"] >= 1


class TestSessions:
    def test_session_frames_equal_video_stream(self, daemon_scenario):
        """Three frames of one session: the stream's warm-started
        answers, bit for bit, the first frame cold."""
        got = daemon_scenario["session"]
        assert [c for c, _, _ in got] == [200, 200, 200]
        for (_, r, _), want in zip(got, daemon_scenario["session_ref"]):
            np.testing.assert_array_equal(_image(r), want)
        # A session's key is the batch-1 grain, this daemon's grain:
        # the sessionless traffic of the same shape warmed it.
        assert [r["cache"] for _, r, _ in got] == ["hit", "hit", "hit"]

    def test_session_request_ids(self, daemon_scenario):
        assert daemon_scenario["session_ids"] == [
            "clip-0", "clip-1", "clip-2",
        ]


class TestRequestTracing:
    """Every /synthesize exit echoes a request id, each settled request
    leaves ONE connected `serve_request` span tree on the daemon
    tracer, every outcome leaves an access-log line whose phase
    attribution reconstructs the measured latency, and `trace <id>`
    renders it back."""

    def test_request_id_echoed_or_generated(self, daemon_scenario):
        _, cold, _ = daemon_scenario["cold"]
        assert re.fullmatch(r"[0-9a-f]{12}", cold["request_id"])
        _, warm, _ = daemon_scenario["warm"]
        assert warm["request_id"] == "pin-req-1"
        code, r, _ = daemon_scenario["bad_rid"]
        assert code == 200
        assert re.fullmatch(r"[0-9a-f]{12}", r["request_id"])

    def test_trace_context_echoed_recorded_or_replaced(
        self, daemon_scenario
    ):
        """X-Parent-Span / X-Trace-Hop: echoed in the body, recorded on
        the request's span root and access-log line; a malformed value
        is replaced, never rejected."""
        code, r, _ = daemon_scenario["traced"]
        assert code == 200
        assert (r["parent_span"], r["hop"]) == ("router-span-7", 2)
        (root,) = [sp for sp in daemon_scenario["tracer"].roots
                   if sp.attrs.get("request_id") == "hop-req-1"]
        assert root.attrs["parent_span"] == "router-span-7"
        assert root.attrs["hop"] == 2
        (entry,) = [e for e in daemon_scenario["access"]
                    if e["request_id"] == "hop-req-1"]
        assert (entry["parent_span"], entry["hop"]) == ("router-span-7", 2)
        code, r, _ = daemon_scenario["bad_parent"]
        assert code == 200 and r["hop"] == 1
        assert re.fullmatch(r"[0-9a-f]{12}", r["parent_span"])

    def test_error_paths_carry_error_and_request_id(
        self, daemon_scenario
    ):
        code, r, _ = daemon_scenario["bad"]
        assert code == 400 and r["status"] == "rejected"
        assert r["error"] and re.fullmatch(
            r"[0-9a-f]{12}", r["request_id"]
        )
        code, r, _ = daemon_scenario["gave_up"]
        assert code == 500 and r["error"] and r["request_id"]
        shed = [r for c, r, _ in daemon_scenario["burst"] if c == 429]
        assert shed
        assert all(r["error"] and r["request_id"] for r in shed)

    def test_one_connected_span_tree_per_request(self, daemon_scenario):
        tracer = daemon_scenario["tracer"]
        roots = [
            sp for sp in tracer.roots if sp.name == "serve_request"
        ]
        by_rid = {sp.attrs["request_id"]: sp for sp in roots}
        assert len(by_rid) == len(roots)
        for key, outcome in (("cold", "ok"), ("warm", "ok"),
                             ("gave_up", "failed")):
            rid = daemon_scenario[key][1]["request_id"]
            assert by_rid[rid].attrs["outcome"] == outcome, key
        warm = by_rid["pin-req-1"]
        names = [c.name for c in warm.children]
        assert names[:5] == [
            "queued", "admitted", "cache-hit", "executed", "demuxed",
        ]
        assert warm.attrs["run_attached"] >= 1
        assert "level" in names  # the runner's own spans, same tree
        assert warm.wall_ms is not None
        assert all(
            c.wall_ms is not None and c.wall_ms <= warm.wall_ms + 1.0
            for c in warm.children[:5]
        )
        # The lean run tracer skipped the level energy readback.
        levels = [c for c in warm.children if c.name == "level"]
        assert levels and all(
            c.attrs.get("nnf_energy") is None for c in levels)

    def test_flight_dump_joins_requests_and_validates(
        self, daemon_scenario
    ):
        from check_report import validate_flight

        from image_analogies_tpu_torch.telemetry.flight import (
            request_events,
        )

        dump = daemon_scenario["flight"]
        assert validate_flight(dump) == []
        evs = request_events(dump, "pin-req-1")
        assert any(ev["name"] == "serve_request" for ev in evs)
        assert any(ev["kind"] == "close" for ev in evs)

    def test_access_log_covers_every_outcome(self, daemon_scenario):
        entries = daemon_scenario["access"]
        outcomes = {e["outcome"] for e in entries}
        assert {"ok", "failed", "shed", "rejected"} <= outcomes
        for e in entries:
            assert e["request_id"] and e["route"] == "/synthesize"
            assert e["total_ms"] >= 0 and e["bytes_in"] >= 0
        warm = [e for e in entries if e["request_id"] == "pin-req-1"]
        assert len(warm) == 1
        assert warm[0]["cache"] == "hit" and warm[0]["exec_key"]
        assert warm[0]["t0"] > 0

    def test_phase_attribution_within_5pct(self, daemon_scenario):
        """accept+ingest+queue+compile+execute+demux+encode explain the
        measured end-to-end latency of the warm request to within 5 %
        (the port's clock runs from the connection's accept to its
        payload; the reference's from enqueue to done, without accept,
        ingest and encode).  (The reference also asks the warm prologue
        to be a tenth of the cold one, its jit compile; the port
        compiles nothing per shape.)"""
        from image_analogies_tpu_torch.serving.accesslog import (
            phase_fields,
        )

        (warm,) = [
            e for e in daemon_scenario["access"]
            if e["request_id"] == "pin-req-1"
        ]
        phases = phase_fields(warm)
        assert [p for p, _ in phases] == [
            "accept", "ingest", "queue", "compile", "execute", "demux",
            "encode",
        ]
        attributed = sum(ms for _, ms in phases)
        assert attributed == pytest.approx(
            warm["total_ms"], rel=0.05
        ), (phases, warm["total_ms"])

    def test_slo_route_grades_real_outcomes(self, daemon_scenario):
        slo = daemon_scenario["slo"]
        assert slo["schema_version"] == 1 and slo["kind"] == "slo"
        assert slo["metric"] == "ia_request_duration_ms"
        assert slo["outcomes"]["ok"] >= 4
        assert slo["outcomes"]["failed"] == 1
        assert slo["outcomes"]["shed"] >= 1
        assert slo["outcomes"]["rejected"] >= 1
        by_name = {o["name"]: o for o in slo["objectives"]}
        lat = by_name["warm_p99_latency_ms"]
        assert lat["status"] == "ok" and lat["bad_count"] == 0
        avail = by_name["availability"]
        assert avail["bad_count"] == 1
        assert avail["status"] == "exhausted"
        assert slo["verdict"] == "violated"

    def test_trace_cli_renders_waterfall(self, daemon_scenario, capsys):
        from image_analogies_tpu_torch.cli import main as cli_main

        d = daemon_scenario["trace_dir"]
        rc = cli_main(["trace", "pin-req-1", "--trace-dir", d])
        assert rc == 0
        printed = capsys.readouterr().out
        assert "pin-req-1" in printed
        for phase in ("queue", "compile", "execute", "demux"):
            assert phase in printed
        assert "gap" in printed and "OVER" not in printed
        rc = cli_main([
            "trace", "pin-req-1", "--trace-dir", d, "--format", "json",
        ])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["access"]["request_id"] == "pin-req-1"
        assert any(
            ev["name"] == "serve_request"
            for ev in doc["flight_events"]
        )

    def test_trace_cli_unknown_id_exits_nonzero(
        self, daemon_scenario
    ):
        from image_analogies_tpu_torch.cli import main as cli_main

        with pytest.raises(SystemExit, match="no-such-request"):
            cli_main([
                "trace", "no-such-request",
                "--trace-dir", daemon_scenario["trace_dir"],
            ])


def test_cuda_daemon_without_a_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthDaemon(a, a, SynthConfig(**_SERVE_CFG),
                    registry=MetricsRegistry())

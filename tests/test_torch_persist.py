"""The warm tier of the port (`serving/excache.DiskExecCache`, the
daemon's `--warm-dir`) on the CPU:

  - the index: sealed on a successful dispatch, merged across replicas
    sharing one directory, re-read on a local miss so a sibling's seal
    is a `disk` verdict; an index under another backend fingerprint (a
    JAX-written one included) is an honest miss, an unreadable one a
    counted error and a miss;
  - `restore_warm_set` dispatches every sealed shape once and books the
    wall in `ia_excache_disk_restore_ms`;
  - two port daemons on one warm dir: the second restores the first's
    shapes before it serves (disk verdicts, span `disk-restored`), its
    first request is a hit equal to the first replica's answer, a shape
    the sibling sealed later is a `disk` verdict with its prologue booked
    as `restore_ms`, an epoch eviction leaves the tier serving `disk`,
    and the sentinel's disk reconciliation holds;
  - the reference's parallel-warmup class (tests/test_serving_persist.py),
    run against the port's `run_warmup`.

Frames are 16^2-24^2, two levels, one EM step; torch runs on one
intra-op thread."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import test_serving_persist as ref  # noqa: E402
from image_analogies_tpu.serving import excache as j_ex  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving import excache as t_ex  # noqa: E402
from image_analogies_tpu_torch.serving.accesslog import (  # noqa: E402
    find_request,
)
from image_analogies_tpu_torch.serving.daemon import SynthDaemon  # noqa: E402
from image_analogies_tpu_torch.serving.excache import (  # noqa: E402
    DiskExecCache,
    backend_fingerprint,
    exec_key,
    key_str,
)
from image_analogies_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    set_registry,
)
from image_analogies_tpu_torch.telemetry.sentinel import (  # noqa: E402
    check_serving,
)
from test_torch_serving import (  # noqa: E402
    _SERVE_CFG,
    _body,
    _get,
    _image,
    _post,
)
from torch_ref_swap import swap  # noqa: E402


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    swap(monkeypatch, ref)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestParallelWarmup(ref.TestParallelWarmup):
    pass


def test_reference_names_are_the_ports():
    assert ref.run_warmup is t_ex.run_warmup


# ------------------------------------------------------------ the index
FP = backend_fingerprint("cpu")


def _key(shape):
    return exec_key(shape, SynthConfig(device="cpu", **_SERVE_CFG), 1)


def _disk_counts(reg):
    vals = {}
    for which in ("hits", "misses", "errors"):
        fam = reg.to_dict().get(f"ia_excache_disk_{which}_total")
        vals[which] = sum((fam or {}).get("values", {}).values())
    return vals


class TestDiskIndex:
    def test_seal_then_probe(self, tmp_path):
        reg = MetricsRegistry()
        c = DiskExecCache(str(tmp_path), FP, registry=reg)
        k = _key((24, 24, 3))
        assert c.probe(k) == "miss"
        c.seal(k, (24, 24, 3))
        assert c.probe(k, kind="warmup") == "disk"
        assert _disk_counts(reg) == {"hits": 1, "misses": 1, "errors": 0}
        assert c.warmup_shapes() == [
            {"height": 24, "width": 24, "channels": 3}]
        doc = json.load(open(tmp_path / "index.json"))
        assert doc["fingerprint"] == FP
        assert doc["entries"][key_str(k)] == {
            "shape": [1, 24, 24, 3], "warmup_shape": [24, 24, 3],
            "blobs": []}

    def test_merge_across_writers_and_sibling_seal_seen(self, tmp_path):
        c1 = DiskExecCache(str(tmp_path), FP)
        c2 = DiskExecCache(str(tmp_path), FP)
        k1, k2 = _key((24, 24, 3)), _key((16, 24, 3))
        c1.seal(k1, (24, 24, 3))
        c2.seal(k2, (16, 24, 3))
        keys = set(json.load(open(tmp_path / "index.json"))["entries"])
        assert keys == {key_str(k1), key_str(k2)}
        # c1 started before c2 sealed k2: its local miss re-reads.
        assert c1.probe(k2) == "disk"
        assert DiskExecCache(str(tmp_path), FP).snapshot()["entries"] == 2

    def test_other_fingerprint_is_an_honest_miss(self, tmp_path):
        c1 = DiskExecCache(str(tmp_path), dict(FP, kernels="0" * 16))
        k = _key((24, 24, 3))
        c1.seal(k, (24, 24, 3))
        c2 = DiskExecCache(str(tmp_path), FP)
        assert c2.snapshot()["entries"] == 0 and c2.errors == 0
        assert c2.probe(k) == "miss"

    def test_jax_written_index_is_an_honest_miss(self, tmp_path):
        """The JAX package's tier seals a key with its own fingerprint
        (jax versions, the XLA platform): the port restores nothing."""
        j = j_ex.DiskExecCache(str(tmp_path))
        try:
            k = _key((24, 24, 3))
            with open(os.path.join(j.blob_dir, "stub.jexec"), "wb"):
                pass
            j.seal(k, (24, 24, 3), ["stub.jexec"])
        finally:
            j.release_jax_cache()
        doc = json.load(open(tmp_path / "index.json"))
        assert key_str(k) in doc["entries"] and doc["fingerprint"] != FP
        reg = MetricsRegistry()
        c = DiskExecCache(str(tmp_path), FP, registry=reg)
        assert c.snapshot()["entries"] == 0
        assert c.probe(k) == "miss"
        assert c.restore_warm_set(lambda shape: pytest.fail(
            "restored a JAX-sealed shape")) == []
        assert _disk_counts(reg)["errors"] == 0

    def test_unreadable_index_is_a_counted_error(self, tmp_path):
        (tmp_path / "index.json").write_text("{ torn")
        reg = MetricsRegistry()
        c = DiskExecCache(str(tmp_path), FP, registry=reg)
        assert c.snapshot()["entries"] == 0 and c.errors == 1
        assert c.probe(_key((24, 24, 3))) == "miss"
        assert _disk_counts(reg)["errors"] == 2

    def test_restore_dispatches_each_sealed_shape(self, tmp_path):
        reg = MetricsRegistry()
        c = DiskExecCache(str(tmp_path), FP, registry=reg)
        for s in ((24, 24, 3), (16, 24, 3)):
            c.seal(_key(s), s)
        seen = []
        rep = c.restore_warm_set(seen.append)
        assert seen == [(24, 24, 3), (16, 24, 3)]
        assert [r["shape"] for r in rep] == [[24, 24, 3], [16, 24, 3]]
        gauge = reg.to_dict()["ia_excache_disk_restore_ms"]["values"]
        assert gauge["value"] == c.restore_ms >= 0.0

    def test_fingerprint_names_torch_device_and_kernels(self):
        fp = backend_fingerprint("cpu")
        assert fp["torch"] == torch.__version__
        assert fp["device_kind"] == "cpu" and len(fp["kernels"]) == 16
        assert not torch.cuda.is_initialized()


# ------------------------------------------- two replicas, one warm dir
@pytest.fixture(scope="module")
def warm_scenario(tmp_path_factory):
    """Replica 1 warms 24^2 and serves a 16 x 24 frame (two seals).
    Replica 2 starts on the same warm dir: its warmup restores both;
    its first 24^2 request is a hit.  Then replica 1 serves a 24 x 16
    frame (a third seal, after replica 2 started) and replica 2 gets
    the same shape: a `disk` verdict.  Last, an epoch eviction on
    replica 2 and the 24^2 frame again."""
    work = tmp_path_factory.mktemp("warm")
    rng = np.random.default_rng(12)
    a = rng.random((24, 24, 3)).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random(a.shape), 0, 1).astype(
        np.float32)
    f = {s: rng.random(s + (3,)).astype(np.float32)
         for s in ((24, 24), (16, 24), (24, 16))}
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    warm = str(work / "warm")
    out = {}

    def spawn(i):
        reg = MetricsRegistry()
        d = SynthDaemon(a, ap, cfg, registry=reg, max_batch=1,
                        max_wait_ms=5.0, obs_interval_s=0,
                        state_dir=str(work / f"s{i}"), warm_dir=warm,
                        access_log_path=str(work / f"access{i}.jsonl"))
        return d.start(), reg

    d1, reg1 = spawn(1)
    prev = set_registry(reg1)
    d2 = None
    try:
        out["warm1"] = d1.warmup([{"height": 24, "width": 24,
                                   "channels": 3}])
        out["r1"] = _post(d1.url, _body(f[(24, 24)]))
        assert _post(d1.url, _body(f[(16, 24)]))[0] == 200
        d2, reg2 = spawn(2)
        out["warm2"] = d2.warmup([])
        out["r2"] = _post(d2.url, _body(f[(24, 24)]))
        assert _post(d1.url, _body(f[(24, 16)]))[0] == 200
        out["sibling"] = _post(d2.url, _body(f[(24, 16)]),
                               headers={"X-Request-Id": "sib-1"})
        d2.cache.force_epoch_eviction()
        out["evicted"] = _post(d2.url, _body(f[(24, 24)]))
        out["serving2"] = json.loads(_get(d2.url + "/serving")[1])
        out["metrics2"] = reg2.to_dict()
        out["access2"] = find_request(str(work / "access2.jsonl"), "sib-1")
    finally:
        for d in (d1, d2):
            if d is not None:
                d.stop()
        set_registry(prev)
    return out


class TestWarmDir:
    def test_first_replica_warms_cold(self, warm_scenario):
        assert [r.get("verdict") for r in warm_scenario["warm1"]] == [
            None]

    def test_second_replica_restores_the_sealed_shapes(self,
                                                       warm_scenario):
        s = warm_scenario
        assert [r["verdict"] for r in s["warm2"]] == ["disk", "disk"]
        disk = s["serving2"]["disk_cache"]
        assert sorted(map(tuple, disk["restored"])) == [
            (16, 24, 3), (24, 24, 3)]
        assert disk["restore_ms"] >= 0 and disk["errors"] == 0
        hits = s["metrics2"]["ia_excache_disk_hits_total"]["values"]
        assert hits['{kind="warmup"}'] == 2

    def test_first_request_is_a_hit_equal_to_the_sibling(self,
                                                         warm_scenario):
        (c1, r1, _), (c2, r2, _) = warm_scenario["r1"], warm_scenario["r2"]
        assert c1 == c2 == 200 and r2["cache"] == "hit"
        np.testing.assert_array_equal(_image(r1), _image(r2))

    def test_sibling_seal_is_a_disk_verdict(self, warm_scenario):
        code, r, _ = warm_scenario["sibling"]
        assert code == 200 and r["cache"] == "disk"
        assert "disk-restored" in [sp["name"] for sp in r["spans"]]
        rec = warm_scenario["access2"]
        assert rec["cache"] == "disk" and rec["compile_ms"] == 0.0
        assert "restore_ms" in rec

    def test_eviction_leaves_the_tier_serving(self, warm_scenario):
        code, r, _ = warm_scenario["evicted"]
        assert code == 200 and r["cache"] == "disk"
        np.testing.assert_array_equal(
            _image(r), _image(warm_scenario["r1"][1]))

    def test_sentinel_disk_reconciliation(self, warm_scenario):
        chk = check_serving(warm_scenario["metrics2"])
        assert chk["status"] == "ok", chk

"""The port daemon's archive ends every boot on its final snapshot, and
incident ids stay unique across boots of one process.

  - a sampler tick forced after the drain's final snapshot appends
    nothing: the final record stays the boot's last;
  - a loop of boots, each drained with archive and observatory ticks
    at 0.02 s, ends every boot on its final record, as `history`
    reads it;
  - two incident stores in one process, capturing within one wall
    second, give two ids, and `list_incidents` lists both.

Frames are 16^2, two levels, one EM step; torch runs on one intra-op
thread."""

import os
import time

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.serving.daemon import SynthDaemon
from image_analogies_tpu_torch.telemetry import archive as t_arch
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    set_registry,
)

_CFG = dict(levels=2, matcher="patchmatch", pallas_mode="off",
            em_iters=1, pm_iters=2)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair():
    rng = np.random.default_rng(3)
    return tuple(rng.random((16, 16, 3)).astype(np.float32)
                 for _ in range(2))


def _boot(arch, interval_s):
    a, ap = _pair()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    d = SynthDaemon(a, ap, SynthConfig(device="cpu", **_CFG),
                    registry=reg, max_batch=1, max_wait_ms=5.0,
                    obs_interval_s=interval_s, archive_dir=arch,
                    archive_interval_s=interval_s).start()
    return d, prev


def _boots(arch):
    """boot_id -> that boot's records, in archive order."""
    out = {}
    for rec in t_arch.read_archive_entries(arch):
        if isinstance(rec.get("boot_id"), str):
            out.setdefault(rec["boot_id"], []).append(rec)
    return out


def _ends_final(recs):
    last = recs[-1]
    return last.get("kind") == "snapshot" and last.get("final") is True


def test_tick_after_final_snapshot_appends_nothing(tmp_path):
    arch = str(tmp_path)
    d, prev = _boot(arch, 0.0)
    try:
        assert d._archive_snapshot(final=True)
        d._archive_last_t = -float("inf")
        d._archive_interval_s = 0.02  # the cadence says "due now"
        d._obs_tick()
        assert not d._archive_snapshot()
        assert not d._archive_append("incident", {"id": "inc-late"})
        (recs,) = _boots(arch).values()
        assert _ends_final(recs)
        assert sum(r.get("final") is True for r in recs) == 1
    finally:
        d.stop()
        set_registry(prev)


def test_every_drained_boot_ends_on_its_final_record(tmp_path):
    arch = str(tmp_path)
    for _ in range(4):
        d, prev = _boot(arch, 0.02)
        try:
            time.sleep(0.1)  # several periodic snapshots
            d.begin_drain()
            assert d.drained.wait(30)
            time.sleep(0.06)  # ticks after the drain, before stop
        finally:
            d.stop()
            set_registry(prev)
    boots = _boots(arch)
    assert len(boots) == 4
    for recs in boots.values():
        assert sum(r.get("kind") == "snapshot" for r in recs) >= 2
        assert _ends_final(recs)


def test_incident_ids_unique_across_stores_in_one_process(
        tmp_path, monkeypatch):
    arch = str(tmp_path)
    monkeypatch.setattr(t_arch.time, "time", lambda: 1.7e9)  # one second
    ids = []
    for _ in range(2):
        store = t_arch.IncidentStore(arch, min_interval_s=60.0)
        ids.append(store.capture({"kind": "anomaly"}, {"note": "x"}))
    assert None not in ids and ids[0] != ids[1]
    for inc in ids:
        parts = inc.split("-")
        assert parts[0] == "inc" and int(parts[2]) == os.getpid()
    listed = {i["id"] for i in t_arch.list_incidents(arch)}
    assert listed == set(ids)

"""The serving daemon's request clock covers the whole wall a client
sees: it starts at the connection's accept (before the handler's thread
runs) and the answer's write is timed after it.

  - a served request's access record carries `accept_ms`, and its
    lifecycle phases, accept through encode, tile `total_ms` within 5 %;
  - `GET /request` adds the answer's `write_ms` to the phases and to
    the total, which they then tile within 5 % too, and the write lands
    in the `ia_serve_write_ms` histogram;
  - every connection's accept stamp is taken by its handler (the
    server keeps none), GETs included, and each POST on its own
    connection carries its own accept wait.

Frames are 16^2, two levels, one EM step; torch runs on one intra-op
thread."""

import base64
import http.client
import json
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.serving.accesslog import phase_fields
from image_analogies_tpu_torch.serving.daemon import SynthDaemon
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    set_registry,
)

_CFG = dict(levels=2, matcher="patchmatch", pallas_mode="off",
            em_iters=1, pm_iters=2)


def _body(frame):
    return json.dumps({
        "image_b64": base64.b64encode(frame.tobytes()).decode(),
        "shape": list(frame.shape), "dtype": "float32",
    }).encode()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(4)
    a, ap, f = (rng.random((16, 16, 3)).astype(np.float32)
                for _ in range(3))
    reg = MetricsRegistry()
    prev = set_registry(reg)
    log = str(tmp_path_factory.mktemp("clock") / "access.jsonl")
    d = SynthDaemon(a, ap, SynthConfig(device="cpu", **_CFG), registry=reg,
                    max_batch=1, max_wait_ms=5.0, obs_interval_s=0,
                    access_log_path=log).start()
    out = {}
    try:
        req = urllib.request.Request(
            d.url + "/synthesize", data=_body(f), method="POST",
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "clock-1"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            r.read()
        # Two more through http.client (the server speaks HTTP/1.0:
        # a connection each).
        host = urllib.parse.urlparse(d.url)
        for rid in ("conn-1", "conn-2"):
            conn = http.client.HTTPConnection(host.hostname, host.port,
                                              timeout=120)
            conn.request("POST", "/synthesize", body=_body(f),
                         headers={"Content-Type": "application/json",
                                  "X-Request-Id": rid})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            conn.close()
        for rid in ("clock-1", "conn-1", "conn-2"):
            with urllib.request.urlopen(
                    f"{d.url}/request?id={rid}", timeout=30) as r:
                out[rid] = json.loads(r.read())["request"]
        out["logged"] = {r["request_id"]: r for r in map(
            json.loads, open(log).read().splitlines())}
        out["metrics"] = reg.to_dict()
        out["stamps_left"] = len(d.live._httpd._accepted)
    finally:
        d.stop()
        set_registry(prev)
        torch.set_num_threads(prev_threads)
    return out


def test_phases_from_accept_tile_the_total(served):
    rec = served["clock-1"]
    phases = phase_fields(rec)
    names = [p for p, _ in phases]
    assert names[0] == "accept" and names[-1] == "write"
    assert rec["accept_ms"] >= 0.0 and rec["write_ms"] >= 0.0
    attributed = sum(ms for _, ms in phases)
    assert attributed == pytest.approx(rec["total_ms"], rel=0.05, abs=0.5)
    # The logged record, without the write, tiles its own total.
    logged = served["logged"]["clock-1"]
    assert "write_ms" not in logged
    assert rec["total_ms"] == pytest.approx(
        logged["total_ms"] + rec["write_ms"], abs=2e-3)
    inside = sum(ms for _, ms in phase_fields(logged))
    assert inside == pytest.approx(logged["total_ms"], rel=0.05, abs=0.5)


def test_write_lands_in_its_histogram(served):
    cells = served["metrics"]["ia_serve_write_ms"]
    assert cells["kind"] == "histogram"
    counts = [v["count"] for v in cells["values"].values()]
    assert sum(counts) == 3


def test_every_accept_stamp_is_taken(served):
    assert served["stamps_left"] == 0
    for rid in ("conn-1", "conn-2"):
        rec = served[rid]
        assert rec["accept_ms"] >= 0.0 and rec["write_ms"] >= 0.0
        assert rec["total_ms"] >= rec["accept_ms"] + rec["ingest_ms"]

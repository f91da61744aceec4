"""The shape lattice of the port (`serving/lattice.py`, the daemon's
lattice admission and `queueing.demux`'s crop) against the JAX
package's, on the CPU:

  - the reference's unit classes (tests/test_lattice.py: rungs, bucket
    lookup, spec grammar, planner, demux crop, the shape-cardinality
    watch), run against the port's modules;
  - parity: `parse_lattice_spec`, `bucket_for` over a grid of shapes and
    `plan_lattice` equal to the JAX package's; `--lattice 768:1024`
    plans 4 buckets, 1000 x 900 maps to 1024 x 1024 and 1100 x 1024
    bypasses;
  - a port daemon under a lattice: warmup dispatches the whole grid, a
    never-seen shape is a warm hit whose answer is the crop of the
    library's dispatch of the edge-padded frame, an on-bucket frame is
    byte-identical to the lattice-off dispatch, a frame over the top
    rung is an honest miss equal to the exact dispatch, and the
    counters, gauges, `/serving` section and observed warmup follow.

Frames are 1^2-30^2, two levels, one EM step; torch runs on one
intra-op thread."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import test_lattice as ref  # noqa: E402
from image_analogies_tpu.serving import lattice as j_lat  # noqa: E402
from image_analogies_tpu_torch import synthesize_batch  # noqa: E402
from image_analogies_tpu_torch.config import SynthConfig  # noqa: E402
from image_analogies_tpu_torch.serving import lattice as t_lat  # noqa: E402
from image_analogies_tpu_torch.serving.daemon import (  # noqa: E402
    SynthDaemon,
    _luma_bucket,
)
from image_analogies_tpu_torch.serving.excache import (  # noqa: E402
    load_observed_warmup,
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
    assert ref.ShapeLattice is t_lat.ShapeLattice
    assert ref.plan_lattice is t_lat.plan_lattice


# ------------------------------------- the reference's unit classes
class TestRungs(ref.TestRungs):
    pass


class TestBucketFor(ref.TestBucketFor):
    pass


class TestParseSpec(ref.TestParseSpec):
    pass


class TestPlanner(ref.TestPlanner):
    pass


class TestDemuxCrop(ref.TestDemuxCrop):
    pass


class TestShapeCardWatch(ref.TestShapeCardWatch):
    pass


# ---------------------------------------------------------- parity
@pytest.mark.parametrize("spec", [
    None, "off", "on", "16:36", "16:36:1.5", "768:1024", "32:512:1.3",
    "8:8", "100:1000",
])
def test_parse_and_plan_equal_jax(spec):
    tc, jc = t_lat.parse_lattice_spec(spec), j_lat.parse_lattice_spec(spec)
    if jc is None:
        assert tc is None
        return
    assert (tc.min_side, tc.max_side, tc.growth, tc.channels) == (
        jc.min_side, jc.max_side, jc.growth, jc.channels)
    tp, jp = t_lat.plan_lattice(tc), j_lat.plan_lattice(jc)
    assert tp.as_dict() == jp.as_dict()
    lat_t, lat_j = tp.lattice, jp.lattice
    sides = sorted({1, 7, lat_t.rungs[0], lat_t.top, lat_t.top + 1}
                   | {r + d for r in lat_t.rungs for d in (-1, 0, 1)})
    for h in sides:
        for w in sides:
            assert lat_t.bucket_for(h, w) == lat_j.bucket_for(h, w)
            b = lat_t.bucket_for(h, w)
            if b is not None:
                assert t_lat.ShapeLattice.waste_frac(h, w, *b) == \
                    j_lat.ShapeLattice.waste_frac(h, w, *b)


@pytest.mark.parametrize("lat", [t_lat, j_lat])
def test_fleet_phase_lattice_has_four_buckets(lat):
    plan = lat.plan_lattice(lat.parse_lattice_spec("768:1024"))
    assert plan.lattice.rungs == (768, 1024)
    assert plan.lattice.size == 4
    assert plan.lattice.bucket_for(1000, 900) == (1024, 1024)
    assert plan.lattice.bucket_for(1100, 1024) is None


def test_cache_capacity_floored_to_the_grid():
    a = np.zeros((16, 16, 3), np.float32)
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    plan = t_lat.plan_lattice(t_lat.parse_lattice_spec("16:24:1.5"))
    caps = [
        SynthDaemon(a, a, cfg, registry=MetricsRegistry(),
                    cache_capacity=cap, lattice=lat,
                    obs_interval_s=0).cache.snapshot()["capacity"]
        for cap, lat in ((2, plan), (32, plan), (2, None))
    ]
    assert caps == [plan.lattice.size + 2, 32, 2]


# ------------------------------------------- the daemon, end to end
def _dispatch(a, ap, frame, cfg):
    """The library's dispatch of one frame at the daemon's grain."""
    out = synthesize_batch(a, ap, np.stack([frame] * GRAIN), cfg,
                           frame_indices=[0] * GRAIN,
                           _b_stats=_luma_bucket(frame))
    return out[0].numpy()


@pytest.fixture(scope="module")
def lattice_scenario(tmp_path_factory):
    """A port daemon at grain 2 under the lattice 16:24:1.5 (rungs 16,
    24: four buckets) with a state dir; a never-seen 20 x 18 frame, a
    1 x 1 frame, an on-bucket 24 x 16 frame and a 30 x 30 frame over
    the top rung."""
    rng = np.random.default_rng(20)
    a = rng.random((24, 24, 3)).astype(np.float32)
    ap = np.clip(0.6 * a + 0.3 * rng.random(a.shape), 0, 1).astype(
        np.float32)
    frames = {
        "odd": rng.random((20, 18, 3)).astype(np.float32),
        "dot": rng.random((1, 1, 3)).astype(np.float32),
        "on": rng.random((24, 16, 3)).astype(np.float32),
        "big": rng.random((30, 30, 3)).astype(np.float32),
    }
    cfg = SynthConfig(device="cpu", **_SERVE_CFG)
    state = str(tmp_path_factory.mktemp("lattice_state"))
    reg = MetricsRegistry()
    prev = set_registry(reg)
    plan = t_lat.plan_lattice(t_lat.parse_lattice_spec("16:24:1.5"))
    d = SynthDaemon(a, ap, cfg, registry=reg, max_batch=GRAIN,
                    max_wait_ms=5.0, obs_interval_s=0, lattice=plan,
                    state_dir=state).start()
    try:
        warm = d.warmup([])
        resident = d.cache.snapshot()["resident"]
        out = {k: _post(d.url, _body(f)) for k, f in frames.items()}
        serving = json.loads(_get(d.url + "/serving")[1])
        metrics = reg.to_dict()
    finally:
        d.stop()
        set_registry(prev)
    pad = np.pad(frames["odd"], [(0, 24 - 20), (0, 24 - 18), (0, 0)],
                 mode="edge")
    dot = np.pad(frames["dot"], [(0, 15), (0, 15), (0, 0)], mode="edge")
    return {
        "plan": plan, "warm": warm, "resident": resident, "out": out,
        "serving": serving, "metrics": metrics, "state": state,
        "refs": {
            "odd": _dispatch(a, ap, pad, cfg)[:20, :18],
            "dot": _dispatch(a, ap, dot, cfg)[:1, :1],
            "on": _dispatch(a, ap, frames["on"], cfg),
            "big": _dispatch(a, ap, frames["big"], cfg),
        },
    }


class TestLatticeDaemon:
    def test_warmup_dispatches_the_whole_grid(self, lattice_scenario):
        s = lattice_scenario
        assert len(s["warm"]) == s["plan"].lattice.size == 4
        assert s["resident"] == 4

    @pytest.mark.parametrize("name,cache", [
        ("odd", "hit"), ("dot", "hit"), ("on", "hit"), ("big", "miss"),
    ])
    def test_answers_equal_the_library(self, lattice_scenario, name,
                                       cache):
        """The crop contract: lattice(F) == crop(dispatch(pad(F))); an
        on-bucket frame rides unpadded and a bypass its exact shape."""
        code, r, _ = lattice_scenario["out"][name]
        assert code == 200 and r["cache"] == cache
        np.testing.assert_array_equal(_image(r),
                                      lattice_scenario["refs"][name])

    def test_admission_counter_books_every_path(self, lattice_scenario):
        vals = lattice_scenario["metrics"][
            "ia_lattice_admissions_total"]["values"]
        assert vals == {'{path="bucketed"}': 2, '{path="exact"}': 1,
                        '{path="bypass"}': 1}

    def test_gauges(self, lattice_scenario):
        m = lattice_scenario["metrics"]
        waste = [1 - 20 * 18 / 24 ** 2, 1 - 1 / 16 ** 2, 0.0]
        assert m["ia_lattice_bucket_waste_frac"]["values"]["value"] == \
            pytest.approx(sum(waste) / 3, abs=1e-6)
        assert m["ia_lattice_buckets"]["values"]["value"] == 4
        card = m["ia_serve_shape_cardinality"]["values"]
        assert card['{view="raw"}'] == 4
        assert card['{view="bucketed"}'] == card["value"] == 4

    def test_serving_snapshot_carries_the_lattice(self, lattice_scenario):
        lat = lattice_scenario["serving"]["lattice"]
        assert lat["rungs"] == [16, 24] and lat["buckets"] == 4
        assert lat["source"] == "override" and lat["admissions"] == 3
        assert lat["plan"]["chosen"]["growth"] == 1.5

    def test_sentinel_ledgers_balance(self, lattice_scenario):
        assert check_serving(lattice_scenario["metrics"])[
            "status"] == "ok"

    def test_observed_warmup_persists_bucket_shapes(self,
                                                    lattice_scenario):
        got = {(e["height"], e["width"]) for e in load_observed_warmup(
            os.path.join(lattice_scenario["state"],
                         "warmup.observed.json"))}
        assert got == {(24, 24), (16, 16), (24, 16), (30, 30)}

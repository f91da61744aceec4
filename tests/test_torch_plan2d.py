"""The port's mesh planner (parallel/plan2d.py) and collective model
(parallel/comms.py) against the reference's, on the CPU:

  - the reference's planner tests (tests/test_plan2d.py) run against the
    port's module (`torch_ref_swap.swap` rebinds the names they import);
  - the reference's pure comms-model tests (tests/test_comms_model.py:
    the band-merge and re-slab byte models, the 2-D composition) on the
    port's functions;
  - `plan_mesh_shape` gives the reference's `MeshPlan` exactly, and every
    copied model function the reference's value, over device counts,
    shapes and configs;
  - the port's executed-count model: a level's EM steps sum to
    `sharded_a_allreduce_count`, and differ from the reference's site
    count exactly by the polish loop's repeats."""

import inspect

import pytest

import test_comms_model as ref_comms
import test_plan2d as ref_plan
from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.parallel import comms as j_comms
from image_analogies_tpu.parallel import plan2d as j_plan
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.parallel import comms as t_comms
from image_analogies_tpu_torch.parallel import plan2d as t_plan
from torch_ref_swap import swap

_PLAN_TESTS = sorted(
    name for name, fn in inspect.getmembers(ref_plan, inspect.isfunction)
    if name.startswith("test_"))


@pytest.mark.parametrize("name", _PLAN_TESTS)
def test_reference_planner_test(monkeypatch, name):
    swap(monkeypatch, ref_plan)
    getattr(ref_plan, name)()


@pytest.mark.parametrize("cls,name", [
    ("TestShardedACount", "test_band_merge_bytes_model"),
    ("TestSpatialReslab", "test_reslab_bytes_model"),
    ("TestBanded2D", "test_banded_level_composition_model"),
])
def test_reference_comms_model_test(monkeypatch, cls, name):
    swap(monkeypatch, ref_comms)
    # Names a test imports inside its body come from the reference
    # modules: point them at the port's.
    import image_analogies_tpu.parallel.spatial as j_spatial
    from image_analogies_tpu_torch.parallel import spatial as t_spatial

    for fn in ("banded_spatial_level_collectives",
               "sharded_a_allreduce_sites", "spatial_reslab_collectives"):
        monkeypatch.setattr(j_comms, fn, getattr(t_comms, fn))
    monkeypatch.setattr(j_spatial, "slab_halo", t_spatial.slab_halo)
    getattr(getattr(ref_comms, cls)(), name)()


_CFGS = [
    dict(),
    dict(levels=1, em_iters=2, pm_iters=2),
    dict(levels=3, em_iters=3, pm_iters=4, kappa=2.0),
    dict(em_iters=2, pm_polish_iters=1, pm_polish_final_only=False),
    dict(patch_size=7, coarse_patch_size=5, em_iters=1),
    dict(color_mode="rgb", levels=2),
]


@pytest.mark.parametrize("kw", _CFGS)
@pytest.mark.parametrize("n_dev,a_hw,b_hw", [
    (1, (256, 256), (256, 256)),
    (4, (256, 256), (512, 512)),
    (8, (512, 512), (1024, 768)),
    (6, (300, 200), (700, 500)),
])
def test_plan_mesh_shape_equals_the_reference(kw, n_dev, a_hw, b_hw):
    want = j_plan.plan_mesh_shape(n_dev, a_hw, b_hw, JCfg(**kw))
    got = t_plan.plan_mesh_shape(n_dev, a_hw, b_hw, TCfg(device="cpu", **kw))
    assert got.as_attrs() == want.as_attrs()
    capped = t_plan.plan_mesh_shape(n_dev, a_hw, b_hw,
                                    TCfg(device="cpu", **kw),
                                    hbm_bytes=1 << 22)
    assert capped.as_attrs() == j_plan.plan_mesh_shape(
        n_dev, a_hw, b_hw, JCfg(**kw), hbm_bytes=1 << 22).as_attrs()
    assert t_plan.override_plan(2, 3).as_attrs() == \
        j_plan.override_plan(2, 3).as_attrs()


@pytest.mark.parametrize("kw", _CFGS)
def test_comms_models_equal_the_reference(kw):
    jc, tc = JCfg(**kw), TCfg(device="cpu", **kw)
    for ha, wa in ((128, 128), (2048, 2304), (4096, 4096)):
        for per_em in (False, True):
            assert t_comms.sharded_a_allreduce_count(
                tc, ha, wa, per_em=per_em) == \
                j_comms.sharded_a_allreduce_count(jc, ha, wa, per_em=per_em)
            for pol in (None, 0, 1):
                assert t_comms.sharded_a_allreduce_sites(
                    tc, ha, wa, per_em=per_em, polish_iters=pol) == \
                    j_comms.sharded_a_allreduce_sites(
                        jc, ha, wa, per_em=per_em, polish_iters=pol)
        for shape in ((2, 4), (1, 4), (4, 1)):
            assert t_comms.banded_spatial_level_collectives(
                tc, ha, wa, 512, 384, shape) == \
                j_comms.banded_spatial_level_collectives(
                    jc, ha, wa, 512, 384, shape)
    for h, w in ((128, 128), (300, 517), (1024, 1024)):
        assert t_comms.sharded_a_band_merge_bytes(tc, h, w) == \
            j_comms.sharded_a_band_merge_bytes(jc, h, w)
    for n in (1, 2, 3):
        assert t_comms.spatial_reslab_collectives(n) == \
            j_comms.spatial_reslab_collectives(n)
        assert t_comms.spatial_reslab_bytes(4096, 4, n) == \
            j_comms.spatial_reslab_bytes(4096, 4, n)
    assert t_comms.batch_em_collectives() == j_comms.batch_em_collectives()


@pytest.mark.parametrize("kw", _CFGS)
def test_executed_counts_sum_to_the_level_count(kw):
    cfg = TCfg(device="cpu", **kw)
    for ha, wa in ((128, 128), (4096, 4096)):
        steps = [
            t_comms.sharded_a_step_allreduces(
                cfg, ha, wa,
                None if em == cfg.em_iters - 1
                or not cfg.pm_polish_final_only else 0)
            for em in range(cfg.em_iters)
        ]
        assert sum(steps) == t_comms.sharded_a_allreduce_count(cfg, ha, wa)
        # Sites count an engaged polish's loop body once; executed calls
        # count every sweep of it.
        site = t_comms.sharded_a_allreduce_sites(cfg, ha, wa, per_em=True)
        run = t_comms.sharded_a_step_allreduces(cfg, ha, wa)
        from image_analogies_tpu_torch.models.patchmatch import (
            _polish_schedule_for,
        )

        iters, n_random = _polish_schedule_for(cfg, ha, wa)
        assert run - site == (iters - 1) * (8 + n_random)

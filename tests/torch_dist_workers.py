"""Rank functions of the multi-rank CPU tests (tests/test_torch_parallel.py).

`parallel.mesh.spawn` starts its ranks with the "spawn" start method, so
each rank imports the function it runs by name: they live here, in a
module that imports only numpy, torch and the port, never JAX or a test
module that imports it.  Each function runs several checks in one world
and returns, on rank 0, a dict of CPU tensors and numbers.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.parallel import sharded_a as t_sharded
from image_analogies_tpu_torch.parallel.batch import synthesize_batch
from image_analogies_tpu_torch.parallel.mesh import make_mesh, world_rank
from image_analogies_tpu_torch.parallel.sharded_a import synthesize_sharded_a
from image_analogies_tpu_torch.parallel.spatial import synthesize_spatial
from image_analogies_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    parse_label_str,
    set_registry,
)

SPATIAL_BRUTE = dict(levels=2, matcher="brute", em_iters=1)
LEAN = dict(levels=2, em_iters=2, pm_iters=2, feature_bytes_budget=1,
            pallas_mode="interpret")
BATCH = dict(levels=2, matcher="patchmatch", pallas_mode="off",
             em_iters=1, pm_iters=2)


def images(size: int, seed: int = 0, n: int = 3):
    """`n` float32 RGB images of size x size, from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.random((size, size, 3)).astype(np.float32)
                 for _ in range(n))


def banded_images():
    """A and A' at 128^2, B at 256^2."""
    a, ap = images(128, seed=1, n=2)
    (b,) = images(256, seed=5, n=1)
    return a, ap, b


def frames(size: int, n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return rng.random((n, size, size, 3)).astype(np.float32)


def _ledger(reg: MetricsRegistry) -> dict:
    """{"observed": {(axis, kind): n}, "expected": {axis: n}} of the
    collective counters."""
    doc = reg.to_dict()
    out = {"observed": {}, "expected": {}}
    for labels, v in (doc.get("ia_collectives_total") or {}).get(
            "values", {}).items():
        lab = parse_label_str(labels)
        out["observed"][(lab["axis"], lab["kind"])] = v
    for labels, v in (doc.get("ia_collectives_expected_total") or {}).get(
            "values", {}).items():
        out["expected"][parse_label_str(labels)["axis"]] = v
    return out


def _fresh_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    set_registry(reg)
    return reg


def spatial_world(ckpt_dir: str) -> dict:
    """Four ranks: the spatial brute runner on 4 slabs (patch 5 and 11),
    the 2-D 2 x 2 banded lean run and the 1-D run on 2 slabs of the same
    config, with their collective ledgers, and a checkpoint / resume
    round trip."""
    torch.set_num_threads(1)
    out = {}
    a, ap, b = images(64)
    mesh4 = make_mesh(4, device_type="cpu")
    for patch in (5, 11):
        cfg = SynthConfig(device="cpu", patch_size=patch, **SPATIAL_BRUTE)
        out[f"brute{patch}"] = synthesize_spatial(a, ap, b, cfg, mesh4)
    # Traced on every rank: the level spans carry the slabs' walls.  An
    # odd height pads to the slab grain and is cropped back.
    from image_analogies_tpu_torch.telemetry.spans import Tracer

    reg = _fresh_registry()
    tracer = Tracer(registry=reg)
    cfg = SynthConfig(device="cpu", **SPATIAL_BRUTE)
    out["odd"] = synthesize_spatial(a, ap, b[:60], cfg, mesh4,
                                    progress=tracer)
    out["level_walls"] = [
        sp["attrs"].get("shard_walls_ms")
        for sp in tracer.to_dict()["spans"] if sp["name"] == "level"]
    out["imbalance_levels"] = sorted(
        (reg.to_dict().get("ia_shard_imbalance_ratio") or {}).get(
            "values", {}))

    # B at 256^2 so a slab of half its rows (plus halos) is still
    # tile-eligible: level 0 runs lean, A band-sharded over 2 bands.
    a, ap, b = banded_images()
    cfg = SynthConfig(device="cpu", **LEAN)
    reg = _fresh_registry()
    mesh2d = make_mesh(4, axis_names=("bands", "slabs"), shape=(2, 2),
                       device_type="cpu")
    out["banded"] = synthesize_spatial(a, ap, b, cfg, mesh2d)
    out["banded_ledger"] = _ledger(reg)
    reg = _fresh_registry()
    mesh2 = make_mesh(2, device_type="cpu")
    res = synthesize_spatial(a, ap, b, cfg, mesh2)
    out["slabs2_ledger"] = _ledger(reg)
    if world_rank() < 2:
        out["slabs2"] = res
    else:
        assert res is None

    # The re-slab against the global arrays' `_split_slabs(_merge_cores)`
    # (int64 field, float B'), at halo 2 and at 6 (patch 11).
    from image_analogies_tpu_torch.parallel import spatial as t_spatial

    g = torch.Generator().manual_seed(9)
    field = torch.randint(0, 1000, (64, 32, 2), generator=g)
    image = torch.rand((64, 32), generator=g)
    group, slab = mesh4.get_group(), world_rank()
    out["reslab_equal"] = []
    for halo in (2, 6):
        want = [t_spatial._split_slabs(x, 4, halo)[slab]
                for x in (field, image)]
        # Stale halos in, fresh ones out.
        stale = [torch.cat([torch.zeros_like(w[:halo]),
                            w[halo:w.shape[0] - halo],
                            torch.zeros_like(w[:halo])]) for w in want]
        got = t_spatial._reslab(stale, halo, slab, 4, group, "batch")
        merged = t_spatial._merge_cores(
            t_spatial._split_slabs(field, 4, halo), halo)
        out["reslab_equal"].append(
            all(torch.equal(a, b) for a, b in zip(got, want))
            and torch.equal(merged, field))
    flags = [None] * 4
    dist.all_gather_object(flags, out["reslab_equal"])
    out["reslab_equal"] = flags

    # Checkpoints: rank 0 writes; every rank resumes from level 0's
    # predecessor once level 0's artifact is gone.
    a, ap, b = images(64, seed=2)
    cfg = SynthConfig(device="cpu", levels=2, matcher="patchmatch",
                      pallas_mode="off", em_iters=2, pm_iters=2,
                      save_level_artifacts=ckpt_dir)
    out["full"] = synthesize_spatial(a, ap, b, cfg, mesh4)
    dist.barrier()
    if world_rank() == 0:
        out["saved"] = sorted(os.listdir(ckpt_dir))
        os.remove(os.path.join(ckpt_dir, "level_0.npz"))
    dist.barrier()
    cfg_r = SynthConfig(device="cpu", levels=2, matcher="patchmatch",
                        pallas_mode="off", em_iters=2, pm_iters=2)
    out["resumed"] = synthesize_spatial(a, ap, b, cfg_r, mesh4,
                                        resume_from=ckpt_dir,
                                        resume_strict=True)
    return out


def sharded_world(n: int, ckpt_dir: str) -> dict:
    """`n` ranks: sharded-A at 128^2 (the lean level band-sharded) with
    each rank's table rows and the collective ledger; with 2 ranks also
    a checkpoint / resume round trip (in `ckpt_dir`) and the batch
    runner over 3 frames with its ledger."""
    torch.set_num_threads(1)
    out = {}
    a, ap, b = images(128, seed=1)
    cfg = SynthConfig(device="cpu", **LEAN)
    rows = []
    orig = t_sharded.band_table

    def recording(*args, **kw):
        tab = orig(*args, **kw)
        rows.append(int(tab.shape[0]))
        return tab

    t_sharded.band_table = recording
    reg = _fresh_registry()
    try:
        out["sharded"] = synthesize_sharded_a(
            a, ap, b, cfg,
            make_mesh(n, axis_names=("bands",), device_type="cpu"))
    finally:
        t_sharded.band_table = orig
    out["ledger"] = _ledger(reg)
    from image_analogies_tpu_torch.telemetry.sentinel import check_comms

    out["comms_check"] = check_comms(reg.to_dict())["status"]
    gathered = [None] * n
    dist.all_gather_object(gathered, rows)
    out["table_rows"] = gathered
    if n == 2:
        # Resume: rank 0 writes, every rank restarts from level 1.
        mesh = make_mesh(2, axis_names=("bands",), device_type="cpu")
        saving = SynthConfig(device="cpu", save_level_artifacts=ckpt_dir,
                             **LEAN)
        full = synthesize_sharded_a(a, ap, b, saving, mesh)
        dist.barrier()
        if world_rank() == 0:
            os.remove(os.path.join(ckpt_dir, "level_0.npz"))
        dist.barrier()
        resumed = synthesize_sharded_a(a, ap, b, cfg, mesh,
                                       resume_from=ckpt_dir,
                                       resume_strict=True)
        out["sharded_resume_equal"] = bool(torch.equal(full, resumed))
        reg = _fresh_registry()
        a, ap = images(32, seed=3, n=2)
        fr = frames(32, 3)
        cfg = SynthConfig(device="cpu", **BATCH)
        mesh = make_mesh(2, axis_names=("batch",), device_type="cpu")
        got, nnf = synthesize_batch(a, ap, fr, cfg, mesh=mesh,
                                    return_nnf=True)
        out["batch"] = got
        out["batch_nnf"] = torch.as_tensor(nnf)
        out["batch_ledger"] = _ledger(reg)
        from image_analogies_tpu_torch.parallel.batch import _Shard

        sh = _Shard(mesh, 3)
        out["batch_pad"] = (sh.n_pad, sh.per)
    return out


"""The multi-device runners of the port (parallel/mesh.py, spatial.py,
sharded_a.py, batch.py over ranks) on the CPU: gloo worlds of 2-4
spawned ranks standing in for the reference's 8 virtual devices.

  - spatial brute at 64^2, 2 levels, 4 ranks (patch 5 and 11): bit for
    bit the single-device port's B', and within the standing float gap
    of JAX's `synthesize_spatial` on 4 virtual devices;
  - the 2-D 2 x 2 bands x slabs lean run (kappa 0) bit for bit the 1-D
    run on 2 slabs, with the collective ledger observed == expected on
    each axis and the re-slab point to point only;
  - spatial and sharded-A checkpoint / resume round trips across the
    ranks; an odd height padded to the slab grain and cropped back; a
    traced run's per-slab walls;
  - sharded-A at 128^2 (levels 2, em 2, pm 2, feature_bytes_budget 1,
    pallas_mode "interpret") at 2 and 4 ranks: bit for bit the
    single-device lean port, each rank's table 1/n of A's rows, the
    bands ledger equal to `sharded_a_allreduce_count` and the
    sentinel's comms check "ok";
  - the batch runner over 2 ranks: 3 frames padded to 4, equal to the
    single-device run, no collective on the batch axis;
  - `synth --spatial --n-devices 2 --device cpu`: the PNG is the
    library's B';
  - `parallel.mesh`: `make_mesh` refusing more ranks than the world,
    a CUDA mesh or launch (the default) refused without a card, `spawn`
    re-raising a rank's exception.

The ranks run the functions of tests/torch_dist_workers.py (a module
without JAX); each world runs several checks.  Torch runs on one
intra-op thread."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_workers as wk
from image_analogies_tpu_torch import cli as t_cli
from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.models.analogy import create_image_analogy
from image_analogies_tpu_torch.parallel import comms, mesh as t_mesh

SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _single(a, ap, b, **kw):
    return create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw))


def psnr(x, y) -> float:
    mse = float(((np.asarray(x, np.float64) - np.asarray(y, np.float64))
                 ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("spatial_ckpt"))
    return t_mesh.spawn(wk.spatial_world, 4, args=(ckpt,),
                        device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def sharded2(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return t_mesh.spawn(wk.sharded_world, 2, args=(2, ckpt),
                        device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def sharded4(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("sharded4_ckpt"))
    return t_mesh.spawn(wk.sharded_world, 4, args=(4, ckpt),
                        device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("patch", [5, 11])
def test_spatial_brute_equals_the_single_device_port(spatial_run, patch):
    a, ap, b = wk.images(64)
    want = _single(a, ap, b, patch_size=patch, **wk.SPATIAL_BRUTE)
    got = spatial_run[f"brute{patch}"]
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_spatial_odd_height_and_shard_walls(spatial_run):
    """A 60-row B pads to the slab grain and comes back 60 rows; a
    traced run's level spans carry every slab's wall (gathered to every
    rank) and the imbalance gauge a level."""
    odd = spatial_run["odd"]
    assert odd.shape == (60, 64, 3) and torch.isfinite(odd).all()
    walls = spatial_run["level_walls"]
    assert len(walls) == 2
    assert all(len(w) == 4 and min(w) >= 0 for w in walls)
    assert len(spatial_run["imbalance_levels"]) == 2


def test_spatial_brute_against_jax_spatial(spatial_run):
    """JAX's runner on 4 of the 8 virtual CPU devices: the same field,
    so only float-level gaps (the single-image brute gap is 80 dB at
    48^2, tests/test_torch_synthesis.py)."""
    import jax.numpy as jnp

    from image_analogies_tpu.config import SynthConfig as JCfg
    from image_analogies_tpu.parallel.mesh import make_mesh as j_mesh
    from image_analogies_tpu.parallel.spatial import synthesize_spatial

    a, ap, b = wk.images(64)
    want = np.asarray(synthesize_spatial(
        *(jnp.asarray(x) for x in (a, ap, b)), JCfg(**wk.SPATIAL_BRUTE),
        j_mesh(4)))
    assert psnr(spatial_run["brute5"].numpy(), want) >= 40.0


def test_banded_2d_equals_1d_at_two_slabs(spatial_run):
    got, want = spatial_run["banded"], spatial_run["slabs2"]
    assert got.shape == (256, 256, 3)
    assert torch.isfinite(got).all() and got.std() > 0.05
    assert torch.equal(got, want)


def test_spatial_ledgers_observed_equal_expected(spatial_run):
    """Per axis: the bands' all-reduces and the slabs' re-slab exchanges
    equal the model booked beside them; the slabs axis moves its halos
    point to point only (no all-reduce or all-gather on it)."""
    cfg = SynthConfig(device="cpu", **wk.LEAN)
    for key in ("banded_ledger", "slabs2_ledger"):
        led = spatial_run[key]
        by_axis = {}
        for (axis, _kind), n in led["observed"].items():
            by_axis[axis] = by_axis.get(axis, 0) + n
        assert by_axis == led["expected"]
        slab_kinds = {kind for (axis, kind) in led["observed"]
                      if axis != "bands"}
        assert slab_kinds == {"p2p"}
    # One lean level (A 128^2, em 2): the bands' all-reduces of both EM
    # steps; two levels of em 2, a re-slab each: 3 arrays on the lean
    # level (py, px, B'), 2 on the standard one (the field, B').
    led = spatial_run["banded_ledger"]
    assert led["observed"][("bands", "all_reduce")] == \
        comms.sharded_a_allreduce_count(cfg, 128, 128)
    reslabs = (comms.spatial_reslab_collectives(3)
               + comms.spatial_reslab_collectives(2))
    assert led["observed"][("slabs", "p2p")] == reslabs
    assert spatial_run["slabs2_ledger"]["observed"] == {
        ("batch", "p2p"): reslabs}


def test_reslab_equals_the_global_split(spatial_run):
    """Every rank's point-to-point re-slab equals its slab of the
    gathered arrays split again (halos 2 and 6; edge slabs re-clamped)."""
    assert spatial_run["reslab_equal"] == [[True, True]] * 4


def test_spatial_resume_round_trip(spatial_run):
    assert spatial_run["saved"] == ["level_0.npz", "level_1.npz"]
    assert torch.equal(spatial_run["resumed"], spatial_run["full"])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_a_equals_the_single_device_lean_port(sharded2, sharded4,
                                                      n):
    res = sharded2 if n == 2 else sharded4
    a, ap, b = wk.images(128, seed=1)
    want = _single(a, ap, b, **wk.LEAN)
    assert torch.equal(res["sharded"], want)
    # The one lean level (128^2): each rank's table is 1/n of A's rows.
    assert res["table_rows"] == [[128 * 128 // n]] * n
    n_ar = float(comms.sharded_a_allreduce_count(
        SynthConfig(device="cpu", **wk.LEAN), 128, 128))
    assert res["ledger"] == {"observed": {("bands", "all_reduce"): n_ar},
                             "expected": {"bands": n_ar}}
    assert res["comms_check"] == "ok"


def test_sharded_a_resume_round_trip(sharded2):
    assert sharded2["sharded_resume_equal"] is True


def test_batch_over_two_ranks_equals_one(sharded2):
    from image_analogies_tpu_torch.parallel.batch import synthesize_batch

    a, ap = wk.images(32, seed=3, n=2)
    fr = wk.frames(32, 3)
    want, nnf = synthesize_batch(
        a, ap, fr, SynthConfig(device="cpu", **wk.BATCH), return_nnf=True)
    assert sharded2["batch_pad"] == (1, 2)
    assert torch.equal(sharded2["batch"], want)
    assert np.array_equal(sharded2["batch_nnf"].numpy(), nnf)
    # No collective in an EM step on the batch axis (the model's 0).
    assert comms.batch_em_collectives() == 0
    assert sharded2["batch_ledger"] == {"observed": {}, "expected": {}}


def test_synth_spatial_cli_over_two_ranks(tmp_path):
    a, ap, b = wk.images(64, seed=4)
    paths = []
    for name, img in zip(("A", "Ap", "B"), (a, ap, b)):
        p = str(tmp_path / f"{name}.png")
        Image.fromarray((img * 255).round().astype(np.uint8)).save(p)
        paths.append(p)
    out = str(tmp_path / "bp.png")
    assert t_cli.main([
        "synth", "--a", paths[0], "--ap", paths[1], "--b", paths[2],
        "--out", out, "--spatial", "--n-devices", "2", "--device", "cpu",
        "--levels", "2", "--matcher", "brute", "--em-iters", "1",
    ]) == 0
    from image_analogies_tpu_torch.utils.io import load_image, save_image

    lib = create_image_analogy(
        load_image(paths[0]), load_image(paths[1]), load_image(paths[2]),
        SynthConfig(device="cpu", levels=2, matcher="brute", em_iters=1))
    ref = str(tmp_path / "lib.png")
    save_image(ref, lib.cpu())
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(Image.open(ref)))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cmd", ["batch", "video"])
def test_frames_cli_over_two_ranks_equals_one(tmp_path, monkeypatch, cmd):
    """`batch` / `video --warm off` with `--n-devices 2 --device cpu`:
    3 frames padded to 4 over two gloo ranks, every PNG the one-rank
    run's."""
    from image_analogies_tpu_torch.video import sequence

    # `--warm` installs its mode process-wide: restored after the test.
    monkeypatch.setattr(sequence, "_WARM_MODE", sequence._WARM_MODE)
    a, ap = wk.images(32, seed=3, n=2)
    frames = tmp_path / "frames"
    frames.mkdir()
    paths = []
    for name, img in (("A", a), ("Ap", ap)):
        p = str(tmp_path / f"{name}.png")
        Image.fromarray((img * 255).round().astype(np.uint8)).save(p)
        paths.append(p)
    for i, fr in enumerate(wk.frames(32, 3)):
        Image.fromarray((fr * 255).round().astype(np.uint8)).save(
            frames / f"f{i:02d}.png")
    base = [cmd, "--a", paths[0], "--ap", paths[1], "--frames",
            str(frames), "--device", "cpu", "--levels", "2",
            "--em-iters", "1", "--pm-iters", "2", "--pallas-mode", "off"]
    if cmd == "video":
        base += ["--warm", "off"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert t_cli.main(base + ["--out", one]) == 0
    assert t_cli.main(base + ["--out", two, "--n-devices", "2"]) == 0
    names = sorted(p.name for p in frames.iterdir())
    assert sorted(os.listdir(two)) == names
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(one, name))),
            np.asarray(Image.open(os.path.join(two, name))))


def test_make_mesh_refuses_more_ranks_than_the_world():
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        t_mesh.make_mesh(3, device_type="cpu")


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    """The mesh and the launcher default to the card, as the port's
    entry points do: without one they raise, naming the CPU option,
    and start no world and no rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        t_mesh.make_mesh(1)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        t_mesh.make_hybrid_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        t_mesh.spawn(wk.images, 2, args=(8,))
    assert not torch.distributed.is_initialized()


def test_spawn_reraises_a_rank_exception():
    with pytest.raises(RuntimeError, match="ranks failed(.|\n)*TypeError"):
        t_mesh.spawn(wk.images, 2, args=("not a size",), device_type="cpu",
                     timeout_s=60.0)

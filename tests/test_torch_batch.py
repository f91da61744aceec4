"""The batch runner (BASELINE config 5) against the JAX package and its
own isolation contract, on the CPU:

  - brute `synthesize_batch` against the JAX one on a one-device mesh:
    every frame's B' >= 70 dB from the JAX B' (brute draws no random
    numbers; the single-image config 1 is at 80 dB);
  - PatchMatch on the per-pixel path given JAX's per-frame draws
    (fold_in(fold_in(level_key, em), i), init fold_in(level_key,
    0x1217)): fields equal at every pixel;
  - K1's frame axis: the plain sweep over F frames is bit-equal to F
    single-frame sweeps and agrees with JAX's vmapped
    `tile_sweep(interpret=True)` (rtol 1e-4 / atol 1e-5, offsets equal
    off ties), and one frame-axis launch a sweep on the tile path;
  - isolation: a batched frame equals its solo run, outputs do not
    depend on frames_per_step (1, 2, 3), frame_indices, ragged chunks and
    return_nnf (all exactly equal);
  - checkpoints: the fingerprint string equals JAX's, and each package
    resumes the other's batch checkpoint directory."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels import patchmatch_tile as jpt
from image_analogies_tpu.models import analogy as j_an
from image_analogies_tpu.models import patchmatch as j_pm
from image_analogies_tpu.parallel.batch import synthesize_batch as j_batch
from image_analogies_tpu.parallel.mesh import make_mesh
from image_analogies_tpu_torch import SynthConfig, psnr
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt
from image_analogies_tpu_torch.models import analogy as t_an
from image_analogies_tpu_torch.parallel import batch as t_batch
from image_analogies_tpu_torch.parallel.batch import (
    stack_stats,
    synthesize_batch,
)

from test_torch_matcher import _jax_sweep_offsets
from test_torch_tile import T, _as, _planes, jax_draws
from test_torch_tile_sweep import _assert_sweep_close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, size, frames, color=True):
    rng = np.random.default_rng(seed)
    shape = (size, size, 3) if color else (size, size)
    a = rng.random(shape).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random(shape), 0, 1).astype(np.float32)
    stack = rng.random((frames,) + shape).astype(np.float32)
    return a, ap, stack


def port(a, ap, stack, **kw):
    run_kw = {k: kw.pop(k) for k in ("frames_per_step", "frame_indices",
                                     "return_nnf", "resume_from",
                                     "resume_strict", "_b_stats")
              if k in kw}
    return synthesize_batch(a, ap, stack, SynthConfig(device="cpu", **kw),
                            **run_kw)


BRUTE = dict(levels=2, matcher="brute", em_iters=1, kappa=2.0)


@pytest.fixture(scope="module")
def brute_pair():
    a, ap, stack = _scene(1, 32, 3)
    want = np.asarray(j_batch(a, ap, stack, JCfg(**BRUTE), make_mesh(1)))
    return a, ap, stack, want


def test_brute_batch_against_jax(brute_pair):
    a, ap, stack, want = brute_pair
    got = port(a, ap, stack, **BRUTE).numpy()
    assert got.shape == want.shape
    for i in range(stack.shape[0]):
        assert psnr(got[i], want[i]) >= 70.0, i


class _JaxFrameDraws:
    """The draws of frame `frame` at (level, em) by the JAX batch runner's
    key derivation, for the per-pixel path: level_key = fold_in(PRNGKey
    (seed), level), the frame's key fold_in(fold_in(level_key, em),
    frame), split into the sweeps' keys as `patchmatch_sweeps` does."""

    def __init__(self, seed, level, em, frame=None):
        level_key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
        self.key = jax.random.fold_in(jax.random.fold_in(level_key, em),
                                      frame)

    def offsets(self, iters, radii, h, w, device):
        return _jax_sweep_offsets(self.key, iters, radii, h, w)


def test_per_pixel_batch_given_jax_draws(monkeypatch):
    kw = dict(levels=2, pallas_mode="off", em_iters=2, pm_iters=3)
    a, ap, stack = _scene(2, 32, 2, color=False)
    want_bp, want_nnf = j_batch(a, ap, stack, JCfg(**kw), make_mesh(1),
                                return_nnf=True)

    def init_key(seed, level, device, frame=None):
        level_key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
        return jax.random.fold_in(jax.random.fold_in(level_key, 0x1217),
                                  frame)

    def random_init(key, h, w, ha, wa):
        return T(np.array(j_pm.random_init(key, h, w, ha, wa))).long()

    monkeypatch.setattr(t_an, "SweepDraws", _JaxFrameDraws)
    monkeypatch.setattr(t_an, "init_generator", init_key)
    monkeypatch.setattr(t_an, "random_init", random_init)
    got_bp, got_nnf = port(a, ap, stack, return_nnf=True, **kw)
    # Equal at every pixel: a fault touching a few rows of one frame
    # (a wrong frame key, a clamp off by one) shows here.
    np.testing.assert_array_equal(got_nnf, np.asarray(want_nnf))
    assert psnr(got_bp.numpy(), np.asarray(want_bp)) >= 70.0


def test_frame_axis_plain_sweep(rng):
    """Two frames of one 128^2 level with the coarse pair: the frame-axis
    plain sweep equals the per-frame sweeps bit for bit, and JAX's
    vmapped interpret kernel within its tolerance."""
    h = w = ha = wa = 128
    n_f, coh = 2, 1.4
    specs = jpt.channel_specs(1, 1, JCfg(), True)
    geom_j = jpt.tile_geometry(h, w, specs)
    geom = tpt.tile_geometry(h, w, specs)
    frames_b, a_img = [], None
    for _ in range(n_f):
        bj, a_img = _planes(rng, h, w, ha, wa, True)
        frames_b.append(bj)
    a_planes_j = jpt.prepare_a_planes(*_as(jnp.asarray, a_img), specs)[0]
    a_planes = tpt.prepare_a_planes(*_as(T, a_img), specs)
    b_planes = torch.stack([tpt.prepare_b_planes(*_as(T, bj), geom)
                            for bj in frames_b])
    b_blocked = jnp.stack([
        jnp.stack([jpt.to_blocked(c, geom_j)
                   for c in jpt.channel_images(*_as(jnp.asarray, bj))])
        for bj in frames_b
    ])
    off_y = np.stack([(rng.integers(0, ha, (h, w)) - np.arange(h)[:, None])
                      for _ in range(n_f)]).astype(np.int32)
    off_x = np.stack([(rng.integers(0, wa, (h, w)) - np.arange(w)[None, :])
                      for _ in range(n_f)]).astype(np.int32)
    dist = (0.3 + 0.4 * rng.random((n_f, h, w))).astype(np.float32)
    dist[rng.random((n_f, h, w)) < 0.33] = np.inf
    oy = torch.stack([tpt.to_compact(T(off_y[i]), geom) for i in range(n_f)])
    ox = torch.stack([tpt.to_compact(T(off_x[i]), geom) for i in range(n_f)])
    d_in = torch.stack([tpt.to_compact(T(dist[i]), geom)
                        for i in range(n_f)])
    tabs = [tpt.sample_candidates_blocked(
        oy[i], ox[i], jax_draws(jax.random.PRNGKey(20 + i), 0, geom, ha, wa),
        geom, ha, wa) for i in range(n_f)]
    cy, cx, cv = (torch.stack(t) for t in zip(*tabs))
    cv = cv * T((rng.random(cv.shape) > 0.3).astype(np.int32))
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh)
    got = tpt.tile_sweep(a_planes, b_planes, cy, cx, cv, oy, ox, d_in, **kw)
    assert got[0].shape == oy.shape
    for i in range(n_f):
        one = tpt.tile_sweep(a_planes, b_planes[i], cy[i], cx[i], cv[i],
                             oy[i], ox[i], d_in[i], **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)

    def sweep(b, y, x, oy_, ox_, d_, v):
        return jpt.tile_sweep(
            a_planes_j, b, y, x, oy_, ox_, d_, None, v, specs=specs,
            geom=geom_j, ha=ha, wa=wa, coh_factor=coh, interpret=True)

    blocked = jax.vmap(lambda p: jpt.to_blocked(p, geom_j))
    jo = jax.vmap(sweep)(
        b_blocked, jnp.asarray(cy.numpy()), jnp.asarray(cx.numpy()),
        blocked(jnp.asarray(off_y)), blocked(jnp.asarray(off_x)),
        blocked(jnp.asarray(dist)), jnp.asarray(cv.numpy()))
    for i in range(n_f):
        want = [jpt.from_blocked(x[i], geom_j, h, w) for x in jo]
        _assert_sweep_close(
            [g[i] for g in got], want,
            (T(off_y[i]), T(off_x[i]), T(dist[i])),
            (a_planes, b_planes[i]), h, w, specs=specs, geom=geom, ha=ha,
            wa=wa)


TILE = dict(levels=2, em_iters=2, pm_iters=2, kappa=0.5)


@pytest.fixture(scope="module")
def tile_scene():
    """Three 128^2 frames on the tile path (level 0) and the per-pixel
    path (level 1), with their unchunked batch run."""
    a, ap, stack = _scene(3, 128, 3)
    return a, ap, stack, port(a, ap, stack, return_nnf=True, **TILE)


def test_one_frame_axis_launch_per_sweep(tile_scene, monkeypatch):
    a, ap, stack, _ = tile_scene
    seen = []
    real = tpt.tile_sweep

    def spy(*args, **kw):
        seen.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tpt, "tile_sweep", spy)
    port(a, ap, stack[:2], **TILE)
    # Level 0 only: em_iters x pm_iters sweeps, each over both frames.
    assert seen == [2] * (TILE["em_iters"] * TILE["pm_iters"])


def test_batched_frame_equals_solo_frame(tile_scene):
    a, ap, stack, _ = tile_scene
    n = stack.shape[0]
    stats = stack_stats(torch.as_tensor(stack), SynthConfig(device="cpu"))
    batched = port(a, ap, stack, frame_indices=[0] * n, **TILE)
    for i in range(n):
        solo = port(a, ap, stack[i:i + 1], _b_stats=stats, **TILE)
        assert torch.equal(batched[i], solo[0]), i


@pytest.mark.parametrize("fps", [1, 2, 3])
def test_chunking_invariance(tile_scene, fps):
    a, ap, stack, (out, nnf) = tile_scene
    got, got_nnf = port(a, ap, stack, frames_per_step=fps, return_nnf=True,
                        **TILE)
    assert torch.equal(got, out)
    np.testing.assert_array_equal(got_nnf, nnf)


def test_frame_indices_and_ragged_chunks(tile_scene):
    a, ap, stack, (out, _) = tile_scene
    idx = [5, 1, 5]
    whole = port(a, ap, stack, frame_indices=idx, **TILE)
    ragged = port(a, ap, stack, frame_indices=idx, frames_per_step=2, **TILE)
    assert torch.equal(whole, ragged)
    # Frames 0 and 2 share an identity but not an input.
    assert not torch.equal(whole[0], whole[2])
    # Positional identities are [0, 1, 2]: frame 1 keeps its output.
    assert torch.equal(whole[1], out[1])
    assert not torch.equal(whole[0], out[0])
    with pytest.raises(ValueError, match="frame_indices"):
        port(a, ap, stack, frame_indices=[0], **TILE)
    with pytest.raises(ValueError, match="frames_per_step"):
        port(a, ap, stack, frames_per_step=0, **TILE)


def test_return_nnf(tile_scene):
    a, ap, stack, (out, nnf) = tile_scene
    assert torch.equal(port(a, ap, stack, **TILE), out)
    assert nnf.shape == stack.shape[:3] + (2,)
    assert nnf[..., 0].min() >= 0 and nnf[..., 0].max() < a.shape[0]
    assert nnf[..., 1].min() >= 0 and nnf[..., 1].max() < a.shape[1]


def test_lean_batch_level_matches_solo(tile_scene):
    """A lean level 0 (bf16 tables) with the frame axis: each frame is
    its solo lean run."""
    a, ap, stack, _ = tile_scene
    kw = dict(TILE, feature_bytes_budget=1)
    stats = stack_stats(torch.as_tensor(stack[:2]), SynthConfig(device="cpu"))
    batched, nnf = port(a, ap, stack[:2], frame_indices=[0, 0],
                        return_nnf=True, **kw)
    for i in range(2):
        solo = port(a, ap, stack[i:i + 1], _b_stats=stats, **kw)
        assert torch.equal(batched[i], solo[0])
    assert nnf.shape == (2, 128, 128, 2)


@pytest.mark.parametrize("frame_indices", [None, [3, 3, 4]])
def test_fingerprint_equals_jax(frame_indices):
    stack = torch.zeros(3, 20, 24, 3)
    shape = t_batch._batch_fingerprint_shape(stack, 8, 4, frame_indices)
    want = (3, 20, 24, 3, 8, 4) + tuple(frame_indices or ())
    assert shape == want
    assert t_an._ckpt_fingerprint(SynthConfig(**BRUTE), shape) == \
        j_an._ckpt_fingerprint(JCfg(**BRUTE), want)


def _drop_level0(root):
    removed = 0
    for dirpath, _dirs, files in os.walk(root):
        if "level_0.npz" in files:
            os.unlink(os.path.join(dirpath, "level_0.npz"))
            removed += 1
    return removed


def test_jax_batch_checkpoints_resume_in_port(tmp_path, brute_pair):
    a, ap, stack, want = brute_pair
    ckpt = str(tmp_path / "jax")
    j_batch(a, ap, stack, JCfg(save_level_artifacts=ckpt, **BRUTE),
            make_mesh(1), frames_per_step=2)
    assert sorted(os.listdir(ckpt)) == ["frames_00000", "frames_00002"]
    assert _drop_level0(ckpt) == 2
    got = port(a, ap, stack, frames_per_step=2, resume_from=ckpt,
               resume_strict=True, **BRUTE).numpy()
    for i in range(stack.shape[0]):
        assert psnr(got[i], want[i]) >= 70.0, i


def test_port_batch_checkpoints_resume_in_jax(tmp_path, brute_pair):
    a, ap, stack, want = brute_pair
    ckpt = str(tmp_path / "port")
    port(a, ap, stack, save_level_artifacts=ckpt, **BRUTE)
    assert sorted(os.listdir(ckpt)) == ["level_0.npz", "level_1.npz"]
    with np.load(os.path.join(ckpt, "level_1.npz")) as z:
        assert z["nnf"].shape == (3, 16, 16, 2)
        assert str(z["fingerprint"]).startswith("(3, 32, 32, 3, 3, 0)|")
    assert _drop_level0(ckpt) == 1
    got = np.asarray(j_batch(a, ap, stack, JCfg(**BRUTE), make_mesh(1),
                             resume_from=ckpt, resume_strict=True))
    for i in range(stack.shape[0]):
        assert psnr(got[i], want[i]) >= 70.0, i


def test_ingest_frames_equals_jax(rng):
    from image_analogies_tpu.parallel.batch import ingest_frames as j_ingest

    good = [rng.random((8, 9, 3)).astype(np.float32) for _ in range(3)]
    arrays = [good[0], "not an array", good[1],
              rng.random((8, 9, 4)).astype(np.float32),
              rng.random((5, 5, 3)).astype(np.float32), good[2]]
    got = t_batch.ingest_frames(arrays)
    want = j_ingest(arrays)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] == ["frames[0]", "frames[2]", "frames[5]"]
    stacked = np.stack(good)
    np.testing.assert_array_equal(t_batch.ingest_frames(stacked)[0], stacked)
    with pytest.raises(RuntimeError, match="strict"):
        t_batch.ingest_frames(arrays, strict=True)
    with pytest.raises(RuntimeError, match="no usable"):
        t_batch.ingest_frames(["x"])


def test_ingest_frame_dir_equals_jax(rng, tmp_path):
    from PIL import Image

    from image_analogies_tpu.parallel.batch import ingest_frame_dir as j_dir

    for i, size in enumerate([(12, 10), (12, 10), (7, 7), (12, 10)]):
        img = (rng.random(size + (3,)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"f{i}.png")
    (tmp_path / "f9.png").write_bytes(b"not a png")
    (tmp_path / "notes.txt").write_text("skipped")
    got = t_batch.ingest_frame_dir(str(tmp_path))
    want = j_dir(str(tmp_path))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == ["f0.png", "f1.png", "f3.png"]
    assert [f["path"] for f in got[2]] == [f["path"] for f in want[2]]
    assert len(got[2]) == 2
    with pytest.raises(RuntimeError, match="strict"):
        t_batch.ingest_frame_dir(str(tmp_path), strict=True)

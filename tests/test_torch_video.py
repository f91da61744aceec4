"""The video package against the JAX package and its own contracts, on
the CPU:

  - the temporal signals `frame_delta`, `field_delta`, `warm_schedule`
    (over a grid of deltas), `flicker_metric`, and the cost model
    `level_eta_cost_units`, each equal to JAX's;
  - warm off: the sequence is the port's batch runner at one frame a
    step, bit for bit;
  - warm on with tau = 0: frame 0 equals the batch runner's frame 0 and
    the temporal level is never reached;
  - tau > 0 lowers flicker on a static scene below independent frames;
  - `save_state` / `restore_state` carry a stream across processes;
  - brute `synthesize_video` against JAX's: >= 70 dB per frame (brute
    draws no random numbers)."""

import dataclasses

import numpy as np
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.models import analogy as j_an
from image_analogies_tpu.video import sequence as j_seq
from image_analogies_tpu_torch import SynthConfig, psnr
from image_analogies_tpu_torch.models import analogy as t_an
from image_analogies_tpu_torch.parallel.batch import (
    stack_stats,
    synthesize_batch,
)
from image_analogies_tpu_torch.video import sequence as t_seq
from image_analogies_tpu_torch.video import (
    VideoStream,
    set_warm_mode,
    synthesize_video,
    warm_mode,
)

VIDEO = dict(levels=2, matcher="patchmatch", pallas_mode="off",
             em_iters=1, pm_iters=2)


@pytest.fixture(autouse=True)
def _restore_seams():
    """Each test leaves both packages' warm seams and the thread count
    as it found them."""
    prev, prev_j = warm_mode(), j_seq.warm_mode()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    set_warm_mode(prev)
    j_seq.set_warm_mode(prev_j)
    torch.set_num_threads(n)


def _scene(rng, size=24, frames=3, static=True):
    a = rng.random((size, size, 3)).astype(np.float32)
    ap = rng.random((size, size, 3)).astype(np.float32)
    b = rng.random((size, size, 3)).astype(np.float32)
    stack = (np.repeat(b[None], frames, axis=0) if static
             else rng.random((frames, size, size, 3)).astype(np.float32))
    return a, ap, stack


def cfg(**kw):
    return SynthConfig(device="cpu", **{**VIDEO, **kw})


def test_frame_and_field_delta_equal_jax(rng):
    a = rng.random((16, 16, 3)).astype(np.float32)
    b = a.copy()
    b[:4] += 0.5
    b[5, 5, 1] += 0.5 / 255.0
    for x, y in ((a, a), (a, b), (a[..., 0], b[..., 0]), (a, b[:8])):
        assert t_seq.frame_delta(x, y) == j_seq.frame_delta(x, y)
    f = rng.integers(0, 9, (2, 10, 12, 2))
    g = f.copy()
    g[0, :3, :, 1] += 1
    for x, y in ((f, f), (f, g), (f, g[:1])):
        assert t_seq.field_delta(x, y) == j_seq.field_delta(x, y)


@pytest.mark.parametrize("pm,em", [(6, 3), (4, 2), (1, 1), (2, 5)])
def test_warm_schedule_equals_jax(pm, em):
    for delta in np.linspace(-0.1, 1.2, 27):
        got = t_seq.warm_schedule(cfg(pm_iters=pm, em_iters=em), delta)
        want = j_seq.warm_schedule(JCfg(pm_iters=pm, em_iters=em), delta)
        assert got == want, delta


def test_flicker_metric_equals_jax(rng):
    for out in (rng.random((4, 8, 8, 3)), rng.random((1, 8, 8)),
                rng.random((3, 5, 7))):
        out = out.astype(np.float32)
        assert t_seq.flicker_metric(out) == j_seq.flicker_metric(out)


@pytest.mark.parametrize("kw", [
    dict(), dict(matcher="brute", em_iters=1), dict(steerable=True),
    dict(color_mode="rgb", pm_iters=2, em_iters=1),
])
@pytest.mark.parametrize("runner", ["single", "batch"])
def test_level_eta_cost_units_equal_jax(kw, runner):
    shapes = [[128, 96], [64, 48], [32, 24]]
    """The port prices every runner it has alike: the reference's single
    and batch pricing both give its units."""
    got = t_an.level_eta_cost_units(SynthConfig(**kw), shapes, (100, 80))
    want = j_an.level_eta_cost_units(JCfg(**kw), shapes, (100, 80),
                                     runner=runner)
    assert got == want


def test_warm_off_is_the_batch_runner(rng):
    a, ap, stack = _scene(rng, static=False)
    set_warm_mode("off")
    out, aux = synthesize_video(a, ap, stack, cfg(), return_aux=True)
    want = synthesize_batch(a, ap, stack, cfg(), frames_per_step=1)
    assert torch.equal(out, want)
    assert aux["mode"] == "off" and aux["warm_frames"] == 0
    assert aux["deltas"] == [None] * 3
    assert aux["fields"].shape == (3, 24, 24, 2)


def test_warm_tau0_frame0_is_batch_and_never_temporal(rng, monkeypatch):
    a, ap, stack = _scene(rng, size=32)

    def forbidden(*_a, **_k):
        raise AssertionError("a tau = 0 run reached the temporal level")

    monkeypatch.setattr(t_seq, "_video_level", forbidden)
    set_warm_mode("on")
    out, aux = synthesize_video(a, ap, stack, cfg(), return_aux=True)
    batch = synthesize_batch(a, ap, stack, cfg())
    assert torch.equal(out[0], batch[0])
    assert aux["mode"] == "on" and aux["warm_frames"] == 2
    assert aux["deltas"] == [None, 0.0, 0.0]
    assert aux["schedules"] == [(2, 1), (2, 1), (2, 1)]
    assert aux["fields"].shape == (3, 32, 32, 2)
    assert aux["run_units"] == aux["cold_units"] > 0


def test_warm_on_a_tile_level_shortens_the_schedule(rng):
    """128^2 frames: level 0 on the tile path; warm frames run the
    shortened schedule, priced below the cold one."""
    a, ap, stack = _scene(rng, size=128, frames=2)
    c = cfg(pallas_mode="auto", pm_iters=4, em_iters=2)
    set_warm_mode("on")
    out, aux = synthesize_video(a, ap, stack, c, return_aux=True)
    batch = synthesize_batch(a, ap, stack, c, frames_per_step=1)
    assert torch.equal(out[0], batch[0])
    assert aux["schedules"] == [(4, 2), (2, 1)]
    assert aux["warm_frames"] == 1
    assert 0 < aux["run_units"] / aux["cold_units"] < 1


def test_tau_reduces_flicker_on_static_scene(rng):
    a, ap, stack = _scene(rng, frames=3)
    set_warm_mode("off")
    indep = synthesize_video(a, ap, stack, cfg()).numpy()
    set_warm_mode("on")
    tau = synthesize_video(a, ap, stack, cfg(tau=0.2)).numpy()
    assert tau.shape == indep.shape
    assert t_seq.flicker_metric(tau) < t_seq.flicker_metric(indep)


def test_save_restore_round_trip(rng, tmp_path):
    a, ap, stack = _scene(rng, size=32, frames=3, static=False)
    c = cfg(tau=0.1)
    set_warm_mode("on")
    stats = stack_stats(torch.as_tensor(stack), c)
    ref = VideoStream(a, ap, cfg=c, b_stats=stats, n_stack=3)
    ref.step(stack[0])
    ref.step(stack[1])
    meta = ref.save_state(str(tmp_path / "s"))
    assert meta == {"t": 2, "levels": [0, 1], "has_b_stats": True}
    want = ref.step(stack[2])
    fresh = VideoStream(a, ap, cfg=c, n_stack=3)
    assert fresh.restore_state(str(tmp_path / "s"))
    assert fresh.t == 2
    got = fresh.step(stack[2])
    assert torch.equal(got, want)
    assert fresh.warm_frames == 1
    assert not VideoStream(a, ap, cfg=c).restore_state(str(tmp_path / "x"))


def test_brute_video_against_jax(rng):
    a, ap, stack = _scene(rng, size=32, frames=3, static=False)
    kw = dict(levels=2, matcher="brute", em_iters=2)
    set_warm_mode("on")
    j_seq.set_warm_mode("on")
    want = np.asarray(j_seq.synthesize_video(a, ap, stack, JCfg(**kw)))
    got = synthesize_video(a, ap, stack, SynthConfig(device="cpu", **kw))
    for i in range(3):
        assert psnr(got[i].numpy(), want[i]) >= 70.0, i


def test_video_rejects_bad_shapes(rng):
    a, ap, _ = _scene(rng)
    with pytest.raises(ValueError, match="frames"):
        synthesize_video(a, ap, np.zeros((24, 24), np.float32), cfg())
    with pytest.raises(ValueError):
        set_warm_mode("maybe")
    assert dataclasses.replace(cfg(), tau=0.3).tau == 0.3

"""The temporal-coherence (tau) term and the "direct" state glue against
the JAX package, on the CPU: `temporal_penalty_fn` (rtol 1e-6), the
per-pixel sweeps with a temporal field given the JAX draws (fields equal
except at float ties, distances rtol 1e-5), the matcher's routing (an
active term never reaches the tile path; tau == 0 changes nothing), and
`_level_state_glue`'s "direct" arm (exactly equal)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.models import analogy as j_an
from image_analogies_tpu.models import patchmatch as j_pm
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt
from image_analogies_tpu_torch.models import analogy as t_an
from image_analogies_tpu_torch.models import patchmatch as t_pm

from test_torch_matcher import _jax_sweep_offsets, nnf

T = torch.from_numpy


@pytest.mark.parametrize("tau", [0.1, 2.5])
def test_temporal_penalty_against_jax(rng, tau):
    h, w, ha, wa = 9, 11, 20, 30
    temporal = np.stack([rng.integers(-3, ha + 3, (h, w)),
                         rng.integers(-3, wa + 3, (h, w))], -1).astype(np.int32)
    idx = rng.integers(0, ha * wa, (h * w,)).astype(np.int32)
    want = j_pm.temporal_penalty_fn(jnp.asarray(temporal), tau, ha, wa)(
        jnp.asarray(idx))
    got = t_pm.temporal_penalty_fn(T(temporal).long(), tau, ha, wa)(
        T(idx).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got.max()) > 0.0


def test_temporal_penalty_off():
    field = torch.zeros(4, 4, 2, dtype=torch.long)
    assert t_pm.temporal_penalty_fn(None, 0.5, 8, 8) is None
    assert t_pm.temporal_penalty_fn(field, 0.0, 8, 8) is None
    cfg = TCfg(device="cpu")
    assert not t_pm.temporal_active(field, cfg)
    assert t_pm.temporal_active(field, TCfg(device="cpu", tau=0.1))
    assert not t_pm.temporal_active(None, TCfg(device="cpu", tau=0.1))


@pytest.mark.parametrize("coh,tau", [(1.0, 0.05), (2.0, 0.5)])
def test_patchmatch_sweeps_with_temporal_given_jax_draws(rng, coh, tau):
    h, w, ha, wa, d = 20, 22, 24, 26, 18
    f_b = rng.random((h, w, d)).astype(np.float32)
    f_a = rng.random((ha, wa, d)).astype(np.float32)
    field = nnf(rng, h, w, ha, wa)
    temporal = nnf(rng, h, w, ha, wa)
    key = jax.random.PRNGKey(5)
    iters, n_random = 3, 4
    radii = t_pm.sweep_radii(ha, wa, n_random)
    nnf_j, d_j = j_pm.patchmatch_sweeps(
        jnp.asarray(f_b), jnp.asarray(f_a), jnp.asarray(field), key,
        iters=iters, n_random=n_random, coh_factor=coh,
        temporal=jnp.asarray(temporal), tau=tau)
    nnf_t, d_t = t_pm.patchmatch_sweeps(
        T(f_b), T(f_a), T(field).long(),
        _jax_sweep_offsets(key, iters, radii, h, w), coh_factor=coh,
        temporal=T(temporal).long(), tau=tau)
    same = (nnf_t.numpy() == np.asarray(nnf_j)).all(-1)
    assert same.mean() > 0.99
    np.testing.assert_allclose(d_t.numpy()[same], np.asarray(d_j)[same],
                               rtol=1e-5)
    # The term moved the result: without it the sweeps end elsewhere.
    nnf_0, _ = t_pm.patchmatch_sweeps(
        T(f_b), T(f_a), T(field).long(),
        _jax_sweep_offsets(key, iters, radii, h, w), coh_factor=coh)
    assert (nnf_0.numpy() != nnf_t.numpy()).any()


def _tile_level(rng, kappa=0.0, tau=0.0):
    """A 128^2 tile-eligible level: features, field, raw planes and the
    tile plan of the default config (plain K1 on the CPU)."""
    cfg = TCfg(device="cpu", levels=1, kappa=kappa, tau=tau, pm_iters=2)
    h = w = ha = wa = 128
    img = lambda *s: T(rng.random(s).astype(np.float32))  # noqa: E731
    src_b, flt_b, src_a, flt_a = img(h, w), img(h, w), img(ha, wa), \
        img(ha, wa)
    f_b = t_an.assemble_features(src_b, flt_b, cfg, None, None)
    f_a = t_an.assemble_features(src_a, flt_a, cfg, None, None)
    plan = tpt.plan_channels(1, 1, cfg, False, h, w, ha, wa)
    specs, use_coarse = plan
    raw = t_pm.RawPlanes(
        src_b, flt_b, None, None,
        tpt.prepare_a_planes(src_a, flt_a, None, None, specs), plan)
    return cfg, f_b, f_a, T(nnf(rng, h, w, ha, wa)).long(), raw


def test_active_term_never_reaches_the_tile_path(rng, monkeypatch):
    cfg, f_b, f_a, field, raw = _tile_level(rng, kappa=1.0, tau=0.2)
    temporal = T(nnf(rng, 128, 128, 128, 128)).long()

    def forbidden(*_a, **_k):
        raise AssertionError("an active temporal term reached the tile path")

    monkeypatch.setattr(t_pm, "tile_patchmatch", forbidden)
    matcher = t_pm.PatchMatchMatcher()
    draws = t_pm.SweepDraws(0, 0, 0)
    got = matcher.match(f_b, f_a, field, level=0, cfg=cfg, draws=draws,
                        raw=raw, temporal=temporal)
    want = matcher.match(f_b, f_a, field, level=0, cfg=cfg, draws=draws,
                         raw=None, temporal=temporal)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    stacked = matcher.match_frames(
        f_b[None], f_a, field[None], level=0, cfg=cfg, draws=[draws],
        raw=t_pm._frames_of(raw, None), temporal=temporal[None])
    for g, w_ in zip(stacked, got):
        assert torch.equal(g[0], w_)


def test_tau_zero_changes_nothing(rng):
    cfg, f_b, f_a, field, raw = _tile_level(rng)
    temporal = T(nnf(rng, 128, 128, 128, 128)).long()
    matcher = t_pm.PatchMatchMatcher()
    draws = t_pm.SweepDraws(3, 0, 1)
    for r in (raw, None):
        got = matcher.match(f_b, f_a, field, level=0, cfg=cfg, draws=draws,
                            raw=r, temporal=temporal)
        want = matcher.match(f_b, f_a, field, level=0, cfg=cfg,
                             draws=draws, raw=r)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("coarse_pair", [False, True])
def test_direct_glue_against_jax(rng, lean, coarse_pair):
    h, w, ha, wa = 12, 14, 10, 9
    field = np.stack([rng.integers(-2, ha + 3, (h, w)),
                      rng.integers(-2, wa + 3, (h, w))], -1).astype(np.int32)
    bp = rng.random((h, w)).astype(np.float32)
    bp_c = rng.random((h // 2, w // 2)).astype(np.float32)
    raw = rng.random((h, w)).astype(np.float32)
    prev_j = jnp.asarray(field)
    prev_t = T(field).long()
    if lean:
        prev_j = (prev_j[..., 0], prev_j[..., 1])
        prev_t = (prev_t[..., 0], prev_t[..., 1])
    bp_j = (jnp.asarray(bp), jnp.asarray(bp_c)) if coarse_pair \
        else jnp.asarray(bp)
    bp_t = (T(bp), T(bp_c)) if coarse_pair else T(bp)
    nnf_j, fb_j, fc_j = j_an._level_state_glue(
        lean, "direct", prev_j, bp_j, jnp.asarray(raw), h, w, ha, wa,
        jax.random.PRNGKey(0))
    nnf_t, fb_t, fc_t = t_an._level_state_glue(
        lean, "direct", prev_t, bp_t, T(raw), h, w, ha, wa,
        t_pm.init_generator(0, 0, "cpu"))
    if lean:
        for a, b in zip(nnf_t, nnf_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_array_equal(nnf_t.numpy(), np.asarray(nnf_j))
    np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_j))
    np.testing.assert_array_equal(fc_t.numpy(), np.asarray(fc_j))


def test_frame_keyed_draws():
    """A frame index joins the seed path; without one the single-image
    streams are unchanged."""
    base = t_pm.SweepDraws(7, 2, 1)
    assert base.frame is None
    seeds = {
        int(t_pm.SweepDraws(7, 2, 1, f).gen(0, "cpu").initial_seed())
        for f in (None, 0, 1)
    }
    assert len(seeds) == 3
    assert base.gen(3, "cpu").initial_seed() == t_pm.seed_for(7, 2, 2, 3)
    assert t_pm.SweepDraws(7, 2, 1, 4).gen(3, "cpu").initial_seed() == \
        t_pm.seed_for(7, 2, 2, 3, 4)
    assert t_pm.init_generator(7, 2, "cpu").initial_seed() == \
        t_pm.seed_for(7, 2, 0, 0)
    assert t_pm.init_generator(7, 2, "cpu", frame=5).initial_seed() == \
        t_pm.seed_for(7, 2, 0, 0, 5)
    off_a = base.offsets(2, [8, 4], 5, 6, "cpu")
    off_b = t_pm.sweep_offsets(base.gen(0, "cpu"), 2, [8, 4], 5, 6)
    for a, b in zip(off_a, off_b):
        assert torch.equal(a, b)


def test_config_tau_validated():
    assert JCfg().tau == TCfg().tau == 0.0
    with pytest.raises(ValueError):
        TCfg(tau=-0.1)

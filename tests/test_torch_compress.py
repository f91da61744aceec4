"""The compressed-candidate pipeline of the port against the JAX package,
on the CPU: mode resolution and setters, the int8 A planes (exactly the
JAX int8 planes), K1's plain version in int8 mode against JAX
`tile_sweep(interpret=True, cand_dtype="int8")` and against the float32
sweep on dequantized planes, the coarse PCA pre-prune (masks exactly
equal), the field-informed restarts given the JAX draws (tables exactly
equal), and the compressed path end to end at 128^2 under the reference
tests' gates: dist-ratio <= 1.80 against the exact NN, PSNR >= 35 dB
against the brute oracle, and the streamed polish bit-identical to the
sequential one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels import patchmatch_tile as jpt
from image_analogies_tpu_torch import SynthConfig, create_image_analogy, psnr
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt
from image_analogies_tpu_torch.kernels import polish_stream as tps
from image_analogies_tpu_torch.models import patchmatch as t_pm

from test_torch_tile import T, _as, _planes, jax_draws
from test_torch_tile_sweep import _assert_sweep_close


def test_env_defaults_match_reference():
    assert tpt._CAND_DTYPE == jpt._CAND_DTYPE
    assert tpt._CAND_PRUNE == jpt._CAND_PRUNE
    assert tpt._RESTART_MODE == jpt._RESTART_MODE
    assert tpt._CAND_DTYPES == jpt._CAND_DTYPES
    assert (tpt._Q_SCALE, tpt._Q_ZERO) == (jpt._Q_SCALE, jpt._Q_ZERO)
    assert tpt._PRUNE_SAMPLES == jpt._PRUNE_SAMPLES


def test_resolution_and_setter(monkeypatch):
    monkeypatch.setattr(tpt, "_CAND_DTYPE", "bf16")
    monkeypatch.setattr(tpt, "_CAND_PRUNE", "off")
    assert tpt.resolve_cand_dtype() == "bf16" and tpt.resolve_prune() is None
    tpt.set_cand_compression("int8", "16:8")
    assert tpt.resolve_cand_dtype() == "int8"
    assert tpt.resolve_prune() == (16, 8)
    assert tpt.resolve_cand_dtype("bf16") == "bf16"
    assert tpt.resolve_prune("off") is None
    tpt.set_cand_compression(prune="8:4")
    assert tpt._CAND_DTYPE == "int8" and tpt.resolve_prune() == (8, 4)
    with pytest.raises(ValueError, match="cand_dtype"):
        tpt.set_cand_compression("fp8")
    with pytest.raises(ValueError):
        tpt.set_cand_compression(prune="16-8")
    assert tpt._CAND_DTYPE == "int8" and tpt._CAND_PRUNE == "8:4"


@pytest.mark.parametrize("spec", ["16:8", "off", "", None, (4, 36), "1:1",
                                  "16-8", "0:4", "16:37", "129:2", "a:b"])
def test_parse_prune_matches_reference(spec):
    try:
        want = jpt.parse_prune(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tpt.parse_prune(spec)
        return
    assert tpt.parse_prune(spec) == want


def _unpack_jax_planes(packed, n_chan, ha, wa, p):
    """JAX's packed (rows, Wq - 1, 2C, 128) planes as the port's (C,
    ha + 2P, wa + 2P): sublane 2c of entry q is lane block q of channel
    c, and sublane 2c + 1 of the last entry the final block."""
    pk = np.asarray(packed)
    rows = pk.shape[0]
    out = []
    for c in range(n_chan):
        full = np.concatenate(
            [pk[:, :, 2 * c, :].reshape(rows, -1), pk[:, -1, 2 * c + 1, :]],
            axis=1)
        out.append(full[: ha + 2 * p, : wa + 2 * p])
    return np.stack(out)


@pytest.mark.parametrize("coarse", [False, True])
def test_int8_planes_equal_jax(rng, coarse):
    h = w = 128
    ha, wa = 144, 200
    _, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), coarse)
    (packed,) = jpt.prepare_a_planes(*_as(jnp.asarray, aj), specs,
                                     cand_dtype="int8")
    got = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype="int8")
    assert got.dtype == torch.int8
    want = _unpack_jax_planes(packed, len(specs), ha, wa,
                              tpt.halo_for(specs))
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype="bf16")
    err = (tpt.dequantize_planes(got) - f32).abs().max()
    assert float(err) <= 0.5 / 254.0 + 1e-6


def _sweep_inputs(rng, coarse, h=128, w=128, ha=128, wa=128):
    bj, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = jpt.channel_specs(1, 1, JCfg(), coarse)
    geom = tpt.tile_geometry(h, w, specs)
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    dist = (0.3 + 0.4 * rng.random((h, w))).astype(np.float32)
    dist[rng.random((h, w)) < 0.33] = np.inf
    cy, cx, cv = tpt.sample_candidates_blocked(
        tpt.to_compact(T(off_y), geom), tpt.to_compact(T(off_x), geom),
        jax_draws(jax.random.PRNGKey(11), 0, geom, ha, wa), geom, ha, wa)
    cv = cv * T((rng.random(cv.shape) > 0.3).astype(np.int32))
    return bj, aj, specs, geom, (off_y, off_x, dist), (cy, cx, cv)


@pytest.mark.parametrize("coarse", [False, True])
def test_int8_plain_sweep_against_jax_interpret(rng, coarse):
    h = w = ha = wa = 128
    coh = 1.7
    bj, aj, specs, geom_t, (off_y, off_x, dist), (cy, cx, cv) = \
        _sweep_inputs(rng, coarse)
    geom_j = jpt.tile_geometry(h, w, specs)
    (a_j,) = jpt.prepare_a_planes(*_as(jnp.asarray, aj), specs,
                                  cand_dtype="int8")
    b_blocked = jnp.stack([jpt.to_blocked(c, geom_j) for c in
                           jpt.channel_images(*_as(jnp.asarray, bj))])
    jo = jpt.tile_sweep(
        a_j, b_blocked, jnp.asarray(cy.numpy()), jnp.asarray(cx.numpy()),
        jpt.to_blocked(jnp.asarray(off_y), geom_j),
        jpt.to_blocked(jnp.asarray(off_x), geom_j),
        jpt.to_blocked(jnp.asarray(dist), geom_j), None,
        jnp.asarray(cv.numpy()), specs=specs, geom=geom_j, ha=ha, wa=wa,
        coh_factor=coh, interpret=True, cand_dtype="int8",
    )
    want = [jpt.from_blocked(x, geom_j, h, w) for x in jo]
    a_t = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype="int8")
    b_t = tpt.prepare_b_planes(*_as(T, bj), geom_t)
    got = tpt.tile_sweep(
        a_t, b_t, cy, cx, cv, tpt.to_compact(T(off_y), geom_t),
        tpt.to_compact(T(off_x), geom_t), tpt.to_compact(T(dist), geom_t),
        specs=specs, geom=geom_t, ha=ha, wa=wa, coh_factor=coh,
        cand_dtype="int8",
    )
    _assert_sweep_close(got, want, (T(off_y), T(off_x), T(dist)),
                        (a_t, b_t), h, w, specs=specs, geom=geom_t, ha=ha,
                        wa=wa)
    assert (got[2].numpy()[:h, :w] != dist).mean() > 0.5


def test_int8_sweep_equals_f32_sweep_on_dequantized_planes(rng):
    """The reference's int8 contract: the int8 sweep computes on the
    dequantized grid, so it equals the float32 sweep on host-dequantized
    planes (offsets on every pixel; distances within rtol 1e-5)."""
    ha = wa = 128
    bj, aj, specs, geom, (off_y, off_x, dist), tables = \
        _sweep_inputs(rng, True)
    a_i8 = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype="int8")
    b_t = tpt.prepare_b_planes(*_as(T, bj), geom)
    state = [tpt.to_compact(T(x), geom) for x in (off_y, off_x, dist)]
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.3)
    out_i8 = tpt.tile_sweep(a_i8, b_t, *tables, *state, cand_dtype="int8",
                            **kw)
    out_f = tpt.tile_sweep(tpt.dequantize_planes(a_i8), b_t, *tables, *state,
                           cand_dtype="bf16", **kw)
    assert torch.equal(out_i8[0], out_f[0]) and torch.equal(out_i8[1],
                                                           out_f[1])
    np.testing.assert_allclose(out_i8[2].numpy(), out_f[2].numpy(),
                               rtol=1e-5)


def test_sweep_rejects_planes_of_the_other_mode(rng):
    ha = wa = 128
    bj, aj, specs, geom, (off_y, off_x, dist), tables = \
        _sweep_inputs(rng, False)
    b_t = tpt.prepare_b_planes(*_as(T, bj), geom)
    state = [tpt.to_compact(T(x), geom) for x in (off_y, off_x, dist)]
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    for planes_mode, sweep_mode in (("bf16", "int8"), ("int8", "bf16")):
        a_t = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype=planes_mode)
        with pytest.raises(ValueError, match="cand_dtype"):
            tpt.tile_sweep(a_t, b_t, *tables, *state, cand_dtype=sweep_mode,
                           **kw)


@pytest.mark.parametrize("h,w", [(128, 128), (200, 300)])
def test_tile_sample_positions_equal_jax(h, w):
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), True)
    geom = tpt.tile_geometry(h, w, specs)
    got = tpt.tile_sample_positions(geom, h, w)
    want = jpt.tile_sample_positions(jpt.tile_geometry(h, w, specs), h, w)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("m_keep,k", [(1, 8), (8, 16), (12, 4)])
def test_prune_candidates_equal_jax(rng, m_keep, k):
    h, w, ha, wa = 200, 300, 256, 320
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), True)
    geom = tpt.tile_geometry(h, w, specs)
    shape = (geom.n_ty, geom.n_tx, tpt.K_TOTAL)
    cy = rng.integers(-150, 150, shape).astype(np.int32)
    cx = rng.integers(-150, 150, shape).astype(np.int32)
    cy[..., 5] = cy[..., 2]  # duplicates and edge-clamped twins tie
    cx[..., 5] = cx[..., 2]
    cy[..., 7] = -1000
    valid = (rng.random(shape) > 0.2).astype(np.int32)
    proj_a = rng.random((ha * wa, k), dtype=np.float32)
    proj_b = rng.random((geom.n_ty, geom.n_tx, tpt._PRUNE_SAMPLES, k),
                        dtype=np.float32)
    qy, qx = tpt.tile_sample_positions(geom, h, w)
    got = tpt.prune_candidates(T(cy), T(cx), T(valid), T(proj_b), qy, qx,
                               T(proj_a), ha, wa, m_keep)
    want = jpt.prune_candidates(
        jnp.asarray(cy), jnp.asarray(cx), jnp.asarray(valid),
        jnp.asarray(proj_b), jnp.asarray(qy.numpy()),
        jnp.asarray(qx.numpy()), jnp.asarray(proj_a), ha, wa, m_keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1).numpy() == np.minimum(valid.sum(-1), m_keep)).all()
    assert bool((got <= T(valid)).all())


def test_field_restarts_given_jax_draws(rng, monkeypatch):
    h, w, ha, wa = 200, 300, 256, 320
    specs = jpt.channel_specs(1, 1, JCfg(), True)
    geom_j = jpt.tile_geometry(h, w, specs)
    geom_t = tpt.tile_geometry(h, w, specs)
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    oy_b = jpt.to_blocked(jnp.asarray(off_y), geom_j)
    ox_b = jpt.to_blocked(jnp.asarray(off_x), geom_j)
    oy_c = tpt.to_compact(T(off_y), geom_t)
    ox_c = tpt.to_compact(T(off_x), geom_t)
    monkeypatch.setattr(jpt, "_RESTART_MODE", "coarse")
    key = jax.random.PRNGKey(4)
    for t in range(2):
        want = jpt.sample_candidates_blocked(
            oy_b, ox_b, jax.random.fold_in(key, t), geom_j, ha, wa)
        draws = jax_draws(key, t, geom_t, ha, wa, coarse_restarts=True)
        got = tpt.sample_candidates_blocked(oy_c, ox_c, draws, geom_t, ha, wa)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        uniform = tpt.sample_candidates_blocked(
            oy_c, ox_c, draws._replace(restart=None), geom_t, ha, wa)
        assert not torch.equal(uniform[0][..., -tpt.K_GLOBAL:],
                               got[0][..., -tpt.K_GLOBAL:])


def test_draw_candidates_restart_positions():
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), True)
    geom = tpt.tile_geometry(200, 300, specs)
    gen = torch.Generator().manual_seed(0)
    assert tpt.draw_candidates(gen, geom, 256, 320).restart is None
    r = tpt.draw_candidates(gen, geom, 256, 320, coarse_restarts=True).restart
    assert tuple(r.shape) == (4, geom.n_ty, geom.n_tx, tpt.K_GLOBAL)
    for row, hi in zip(r, (geom.n_ty, geom.n_tx, geom.tile_h, geom.tile_w)):
        assert 0 <= int(row.min()) and int(row.max()) < hi


def _modes(monkeypatch, cand_dtype, prune, polish):
    monkeypatch.setattr(tpt, "_CAND_DTYPE", cand_dtype)
    monkeypatch.setattr(tpt, "_CAND_PRUNE", prune)
    monkeypatch.setattr(t_pm, "_POLISH_MODE", polish)


def _example(size):
    from image_analogies_tpu_torch.utils.examples import super_resolution

    return super_resolution(size)


def test_dist_ratio_gate_128(monkeypatch):
    """The reference's compressed-arm probe (int8 + 16:8) on the rgb
    super-resolution pair: three matcher passes from a zero field, the
    returned field scored under the exact metric against the exact NN.
    Its 150-wide rgb features exceed the streamed table's 128 lanes, so
    the polish is the sequential one, as in the reference's probe."""
    from image_analogies_tpu_torch.models.brute import exact_nn
    from image_analogies_tpu_torch.models.matcher import get_matcher, nnf_dist
    from image_analogies_tpu_torch.models.patchmatch import (
        RawPlanes,
        SweepDraws,
    )
    from image_analogies_tpu_torch.ops.features import assemble_features

    _modes(monkeypatch, "int8", "16:8", "sequential")
    size = 128
    cfg = SynthConfig(levels=1, em_iters=1, pm_iters=6, pm_polish_iters=1,
                      pallas_mode="interpret", device="cpu")
    a, ap, b = (torch.as_tensor(x) for x in _example(size))
    f_b = assemble_features(b, b, cfg, None, None)
    f_a = assemble_features(a, ap, cfg, None, None)
    plan = tpt.plan_channels(3, 3, cfg, False, size, size, size, size)
    a_planes = tpt.prepare_a_planes(a, ap, None, None, plan[0])
    assert a_planes.dtype == torch.int8
    raw = RawPlanes(b, b, None, None, a_planes, plan)
    nnf = torch.zeros(size, size, 2, dtype=torch.long)
    for p in range(3):
        nnf, _ = get_matcher("patchmatch").match(
            f_b, f_a, nnf, level=0, cfg=cfg, draws=SweepDraws(p, 0, 0),
            raw=raw)
    d = f_a.shape[-1]
    d_field = nnf_dist(f_b, f_a.reshape(-1, d), nnf, size)
    _, d_exact = exact_nn(f_b.reshape(-1, d), f_a.reshape(-1, d))
    ratio = float(d_field.mean()) / max(float(d_exact.mean()), 1e-30)
    assert 1.0 <= ratio <= 1.80, ratio


def test_compressed_synthesis_gates_and_stream_bit_identity(monkeypatch):
    """(int8, 16:8, stream) end to end at 128^2: PSNR >= 35 dB against
    the port's brute oracle, B' equal to the sequential polish's, and
    the polish fetching through K3's path the derived number of times:
    per polished EM step of each tile level, 1 + iters * (8 + n_random)
    (`polish_eval_rows` per query row)."""
    a, ap, b = _example(128)
    kw = dict(levels=2, em_iters=1, device="cpu")
    cfg = SynthConfig(matcher="patchmatch", pm_iters=3, pm_polish_iters=1,
                      pallas_mode="interpret", **kw)
    oracle = create_image_analogy(a, ap, b, SynthConfig(matcher="brute",
                                                        **kw))
    calls = []
    real = tps.gather_rows

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tps, "gather_rows", spy)
    _modes(monkeypatch, "int8", "16:8", "stream")
    stream = create_image_analogy(a, ap, b, cfg)
    # Level 0 (128^2) is the one tile level; one polished EM step.
    assert len(calls) == tps.polish_eval_rows(1, cfg.pm_polish_iters,
                                              cfg.pm_polish_random)
    _modes(monkeypatch, "int8", "16:8", "sequential")
    seq = create_image_analogy(a, ap, b, cfg)
    assert len(calls) == 13
    assert torch.equal(stream, seq)
    assert psnr(stream, oracle) >= 35.0


def test_jump_polish_synthesis_against_oracle(monkeypatch):
    """The jump engine end to end at 128^2, against the oracle's 33 dB
    gate."""
    a, ap, b = _example(128)
    kw = dict(levels=2, em_iters=1, device="cpu")
    oracle = create_image_analogy(a, ap, b, SynthConfig(matcher="brute",
                                                        **kw))
    _modes(monkeypatch, "bf16", "off", "jump")
    out = create_image_analogy(a, ap, b, SynthConfig(
        matcher="patchmatch", pm_iters=3, pm_polish_iters=1,
        pallas_mode="interpret", **kw))
    assert torch.isfinite(out).all()
    assert psnr(out, oracle) >= 33.0

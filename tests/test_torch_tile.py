"""The tile path's host side and K1's plain version against the JAX
package, on the CPU: the dedup mask and the candidate tables (exactly
equal, given the JAX draws), the sweep against a numpy window oracle
(rtol 1e-4 / atol 1e-5, the reference kernel tests' tolerance), and the
tile plan.  test_torch_tile_sweep.py holds the sweep against JAX
`tile_sweep(..., interpret=True)`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels import patchmatch_tile as jpt
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt

T = torch.from_numpy


def jax_draws(key, t, geom, ha, wa, coarse_restarts=False):
    """The draws `sample_candidates_blocked` makes for sweep t, by the
    reference's own key derivation (fold_in at models/patchmatch.py, the
    4-way split, then the jitter, perturbation and restart draws); with
    `coarse_restarts`, also the restart positions `_field_restarts`
    draws from the same two restart keys."""
    k_jit, k_loc, k_gy, k_gx = jax.random.split(jax.random.fold_in(key, t), 4)
    th, tw = geom.tile_h, geom.tile_w
    rmax = max(1, max(ha, wa) >> 1)
    shape = (geom.n_ty, geom.n_tx, jpt.K_GLOBAL)
    arr = lambda x: T(np.array(x))  # noqa: E731
    restart = None
    if coarse_restarts:
        kt, ku = jax.random.split(k_gy)
        kj, kv = jax.random.split(k_gx)
        restart = torch.stack([
            arr(jax.random.randint(kt, shape, 0, geom.n_ty)),
            arr(jax.random.randint(kj, shape, 0, geom.n_tx)),
            arr(jax.random.randint(ku, shape, 0, th)),
            arr(jax.random.randint(kv, shape, 0, tw)),
        ])
    return tpt.CandidateDraws(
        jitter=arr(jax.random.randint(k_jit, (2,), 0, min(th, tw))),
        pert=arr(jax.random.randint(
            k_loc, (2, geom.n_ty, geom.n_tx, jpt.K_LOCAL), -rmax, rmax + 1)),
        glob_y=arr(jax.random.randint(k_gy, shape, 0, max(ha - th, 1))),
        glob_x=arr(jax.random.randint(k_gx, shape, 0, max(wa - tw, 1))),
        restart=restart,
    )


def test_candidate_valid_mask(rng):
    cy = rng.integers(-3, 3, (3, 4, jpt.K_TOTAL)).astype(np.int32)
    cx = rng.integers(-3, 3, (3, 4, jpt.K_TOTAL)).astype(np.int32)
    got = tpt.candidate_valid_mask(T(cy), T(cx)).numpy()
    want = np.asarray(jpt.candidate_valid_mask(jnp.asarray(cy),
                                               jnp.asarray(cx)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("hw,a_hw", [((200, 300), (256, 320)),
                                     ((128, 128), (128, 130))])
def test_candidate_tables_given_jax_draws(rng, hw, a_hw):
    (h, w), (ha, wa) = hw, a_hw
    specs_j = jpt.channel_specs(1, 1, JCfg(), True)
    specs_t = tpt.channel_specs(1, 1, TCfg(device="cpu"), True)
    assert specs_t == specs_j
    geom_j = jpt.tile_geometry(h, w, specs_j)
    geom_t = tpt.tile_geometry(h, w, specs_t)
    assert tuple(geom_t) == tuple(geom_j)
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    sample = jax.jit(jpt.sample_candidates_blocked,
                     static_argnums=(3, 4, 5))
    blocked = jax.jit(jpt.to_blocked, static_argnums=1)
    oy_b = blocked(jnp.asarray(off_y), geom_j)
    ox_b = blocked(jnp.asarray(off_x), geom_j)
    oy_c = tpt.to_compact(T(off_y), geom_t)
    ox_c = tpt.to_compact(T(off_x), geom_t)
    key = jax.random.PRNGKey(3)
    for t in range(2):
        want = sample(
            oy_b, ox_b, jax.random.fold_in(key, t), geom_j, ha, wa)
        got = tpt.sample_candidates_blocked(
            oy_c, ox_c, jax_draws(key, t, geom_t, ha, wa), geom_t, ha, wa)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _planes(rng, h, w, ha, wa, coarse):
    img = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    src_b, flt_b, src_a, flt_a = img(h, w), img(h, w), img(ha, wa), img(ha, wa)
    if coarse:
        c = (img((h + 1) // 2, (w + 1) // 2), img((h + 1) // 2, (w + 1) // 2),
             img((ha + 1) // 2, (wa + 1) // 2),
             img((ha + 1) // 2, (wa + 1) // 2))
    else:
        c = (None,) * 4
    return (src_b, flt_b, c[0], c[1]), (src_a, flt_a, c[2], c[3])


def _as(fn, xs):
    return [None if x is None else fn(x) for x in xs]


def _oracle(chans_b, chans_a, specs, oy, ox):
    """The reference tests' numpy windowed-SSD at one shared offset."""
    p = jpt.halo_for(specs)
    h, w = chans_b[0].shape
    d = np.zeros((h, w), np.float64)
    for cb, ca, sp in zip(chans_b, chans_a, specs):
        r = len(sp.wy) // 2
        bp = np.pad(cb.astype(np.float32), p, mode="edge")
        apad = np.pad(ca.astype(np.float32), p, mode="edge")
        for ty, wy in enumerate(sp.wy):
            for tx, wx in enumerate(sp.wx):
                dy = (ty - r) * sp.dilation
                dx = (tx - r) * sp.dilation
                bwin = bp[p + dy : p + dy + h, p + dx : p + dx + w]
                awin = apad[p + oy + dy : p + oy + dy + h,
                            p + ox + dx : p + ox + dx + w]
                d += wy * wx * (bwin - awin) ** 2
    return d


@pytest.mark.parametrize("offset,coarse", [((0, 0), False), ((2, 3), False),
                                           ((17, 7), False), ((5, 4), True)])
def test_plain_sweep_against_numpy_oracle(rng, offset, coarse):
    oy, ox = offset
    h, w, ha, wa = 128, 128, 224, 256
    bj, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), coarse)
    geom = tpt.tile_geometry(h, w, specs)
    shape = (geom.n_ty, geom.n_tx, tpt.K_TOTAL)
    z = torch.zeros(geom.n_ty * 64, geom.n_tx * geom.tile_w, dtype=torch.int32)
    oy_o, ox_o, d_o = tpt.tile_sweep(
        tpt.prepare_a_planes(*_as(T, aj), specs),
        tpt.prepare_b_planes(*_as(T, bj), geom),
        torch.full(shape, oy, dtype=torch.int32),
        torch.full(shape, ox, dtype=torch.int32),
        torch.ones(shape, dtype=torch.int32), z, z,
        torch.full(z.shape, float("inf")),
        specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0,
    )
    chans_b = [c.numpy() for c in tpt.channel_images(*_as(T, bj))]
    chans_a = [c.numpy() for c in tpt.channel_images(*_as(T, aj))]
    np.testing.assert_allclose(
        d_o.numpy()[:h, :w], _oracle(chans_b, chans_a, specs, oy, ox),
        rtol=1e-4, atol=1e-5)
    assert (oy_o.numpy() == oy).all() and (ox_o.numpy() == ox).all()


@pytest.mark.parametrize("coarse", [False, True])
def test_pixel_dist_and_unexplained_offsets(rng, coarse):
    h, w, ha, wa = 128, 128, 224, 256
    bj, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = tpt.channel_specs(1, 1, TCfg(device="cpu"), coarse)
    geom = tpt.tile_geometry(h, w, specs)
    geo = dict(specs=specs, geom=geom, ha=ha, wa=wa)
    planes = (tpt.prepare_a_planes(*_as(T, aj), specs),
              tpt.prepare_b_planes(*_as(T, bj), geom))

    # The per-pixel metric is the numpy oracle's; a match outside A is inf.
    qy, qx = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(h), torch.arange(w), indexing="ij"))
    chans_b = [c.numpy() for c in tpt.channel_images(*_as(T, bj))]
    chans_a = [c.numpy() for c in tpt.channel_images(*_as(T, aj))]
    d = tpt.pixel_dist(*planes, qy, qx, torch.full_like(qy, 5),
                       torch.full_like(qx, 9), **geo)
    np.testing.assert_allclose(d.reshape(h, w).numpy(),
                               _oracle(chans_b, chans_a, specs, 5, 9),
                               rtol=1e-4, atol=1e-5)
    edge = tpt.pixel_dist(*planes, qy[:2], qx[:2], torch.tensor([-1, 0]),
                          torch.tensor([0, wa]), **geo)
    assert torch.isinf(edge).all()

    # A sweep explains itself; one moved offset is caught, unless every
    # offset ties (constant planes).
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    state = (tpt.to_compact(T(off_y), geom), tpt.to_compact(T(off_x), geom),
             torch.full((geom.n_ty * 64, geom.n_tx * geom.tile_w),
                        float("inf")))
    gen = torch.Generator().manual_seed(2)
    tables = tpt.sample_candidates_blocked(
        state[0], state[1], tpt.draw_candidates(gen, geom, ha, wa), geom,
        ha, wa)
    for flat in (False, True):
        pl = tuple(torch.full_like(x, 0.5) for x in planes) if flat else planes
        out = tpt.tile_sweep(*pl, *tables, *state, coh_factor=1.3, **geo)
        assert not tpt.unexplained_offsets(out, out, state, *pl, h=h, w=w,
                                           **geo).any()
        moved = out[0].clone()
        moved[3, 5] += 1
        bad = tpt.unexplained_offsets((moved, out[1], out[2]), out, state,
                                      *pl, h=h, w=w, **geo)
        assert int(bad.sum()) == (0 if flat else 1)
        assert flat or bool(bad[3, 5])


def test_plan_channels_geometry_rule():
    cfg_t, cfg_j = TCfg(device="cpu"), JCfg()
    for h, w, ha, wa in [(128, 128, 128, 128), (127, 300, 256, 256),
                         (256, 256, 67, 256), (512, 512, 512, 512)]:
        want = jpt.plan_channels(1, 1, cfg_j, True, h, w, ha, wa)
        got = tpt.plan_channels(1, 1, cfg_t, True, h, w, ha, wa)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == want[:2]


def test_kernel_resource_check():
    specs = tpt.channel_specs(5, 1, TCfg(device="cpu", steerable=True), True)
    assert tpt.kernel_fits(specs)
    assert tpt.kernel_smem_bytes(len(specs), 2) <= tpt.SMEM_LIMIT
    wide = tpt.channel_specs(1, 1, TCfg(device="cpu", patch_size=15), False)
    assert not tpt.kernel_fits(wide)  # halo 7 has no instantiation

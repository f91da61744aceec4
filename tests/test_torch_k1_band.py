"""K1's banded mode, plain version, on the CPU.

  - `band_rows`, `band_bounds` and `prepare_a_planes(n_bands=)` equal
    the reference's (band planes compared on the port's layout: the
    reference's packed rows, unpacked, at the same A rows); one band
    built alone (`band=`) equals its rows of the whole planes;
  - each band's sweep against the reference's banded `tile_sweep` in
    interpret mode at 128^2, from the same incoming state, planes and
    candidate tables (the JAX draws): distances within rtol 1e-4 /
    atol 1e-5, offsets equal except at ties;
  - the bands swept in turn with carried state give the single-band
    sweep bit for bit (kappa factor 1: strict-improvement accepts), as
    the reference's `test_sharded_a_band_search_matches_sequential`
    pins for its kernel;
  - a band launch on planes too short for its rows is refused."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels import patchmatch_tile as jpt
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt

from test_torch_tile import T, _as, _planes, jax_draws
from test_torch_tile_sweep import _assert_sweep_close


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(rng, coarse, h=128, ha=128):
    w = wa = 128
    bj, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = jpt.channel_specs(1, 1, JCfg(), coarse)
    geom_t = tpt.tile_geometry(h, w, specs)
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    dist = (0.3 + 0.4 * rng.random((h, w))).astype(np.float32)
    dist[rng.random((h, w)) < 0.33] = np.inf
    cy, cx, cv = tpt.sample_candidates_blocked(
        tpt.to_compact(T(off_y), geom_t), tpt.to_compact(T(off_x), geom_t),
        jax_draws(jax.random.PRNGKey(5), 0, geom_t, ha, wa), geom_t, ha, wa)
    return dict(h=h, w=w, ha=ha, wa=wa, bj=bj, aj=aj, specs=specs,
                geom_t=geom_t, off_y=off_y, off_x=off_x, dist=dist,
                cand=(cy, cx, cv))


@pytest.mark.parametrize("ha,n_bands", [(128, 2), (200, 3), (130, 4)])
def test_band_bounds_and_planes_equal_the_reference(rng, ha, n_bands):
    assert tpt.band_rows(ha, n_bands) == jpt.band_rows(ha, n_bands)
    assert tpt.band_bounds(ha, n_bands) == [
        tuple(int(v) for v in np.asarray(b))
        for b in jpt.band_bounds(ha, n_bands)]
    src, flt = (rng.random((ha, 128)).astype(np.float32) for _ in range(2))
    specs = jpt.channel_specs(1, 1, JCfg(), False)
    p = tpt.halo_for(specs)
    full = tpt.prepare_a_planes(T(src), T(flt), None, None, specs)
    bands = tpt.prepare_a_planes(T(src), T(flt), None, None, specs,
                                 n_bands=n_bands)
    assert isinstance(bands, tuple) and len(bands) == n_bands
    rows_b = tpt.band_rows(ha, n_bands)
    span = rows_b + tpt.TILE_H - 1 + 2 * p
    for i, planes in enumerate(bands):
        assert planes.shape == (2, span, 128 + 2 * p)
        # Rows inside A (plus its halo) are the whole planes' rows.
        top = i * rows_b
        inside = min(span, full.shape[1] - top)
        torch.testing.assert_close(planes[:, :inside],
                                   full[:, top:top + inside], rtol=0, atol=0)
        # Past A: the last row repeated (the reference's edge pad).
        if inside < span:
            assert bool((planes[:, inside:] == full[:, -1:]).all())
    (one,) = tpt.prepare_a_planes(T(src), T(flt), None, None, specs,
                                  n_bands=1)
    assert torch.equal(one, full)


@pytest.mark.parametrize("coarse,cand_dtype,ha,n_bands", [
    (False, "bf16", 128, 2), (True, "bf16", 130, 4), (True, "int8", 200, 3),
])
def test_one_band_is_built_from_its_own_rows(rng, monkeypatch, coarse,
                                             cand_dtype, ha, n_bands):
    """`prepare_a_planes(n_bands=, band=i)` (one rank's planes in a
    band-sharded run) equals band i of the whole planes, coarse pair
    and int8 grid included, and holds rows_b + TILE_H - 1 + 2P rows,
    gathered alone: the whole planes are never formed for it."""
    wa = 96
    _, aj = _planes(rng, 8, 8, ha, wa, coarse)
    specs = jpt.channel_specs(1, 1, JCfg(), coarse)
    p = tpt.halo_for(specs)
    full = tpt.prepare_a_planes(*_as(T, aj), specs, cand_dtype=cand_dtype)
    rows_b = tpt.band_rows(ha, n_bands)
    span = rows_b + tpt.TILE_H - 1 + 2 * p

    gathered = []
    rows_of = tpt._channel_rows

    def spy(*a):
        gathered.append(len(a[-1]))
        return rows_of(*a)

    monkeypatch.setattr(tpt, "_channel_rows", spy)
    for i in range(n_bands):
        planes = tpt.prepare_a_planes(*_as(T, aj), specs,
                                      cand_dtype=cand_dtype,
                                      n_bands=n_bands, band=i)
        assert planes.shape == (len(specs), span, wa + 2 * p)
        assert planes.dtype == full.dtype
        top = i * rows_b
        inside = min(span, full.shape[1] - top)
        assert torch.equal(planes[:, :inside], full[:, top:top + inside])
        if inside < span:
            assert bool((planes[:, inside:] == full[:, -1:]).all())
    # Each band gathered its own rows, nothing wider.
    assert gathered == [span] * n_bands


@pytest.mark.parametrize("coarse,n_bands", [(False, 2), (True, 3)])
def test_band_sweep_against_jax_interpret(rng, coarse, n_bands):
    s = _setup(rng, coarse)
    h, w, ha, wa, specs = s["h"], s["w"], s["ha"], s["wa"], s["specs"]
    geom_j = jpt.tile_geometry(h, w, specs)
    geom_t = s["geom_t"]
    coh = 1.7
    bands_j = jpt.prepare_a_planes(*_as(jnp.asarray, s["aj"]), specs,
                                   n_bands=n_bands)
    bounds_j = jpt.band_bounds(ha, n_bands)
    b_blocked = jnp.stack([
        jpt.to_blocked(c, geom_j)
        for c in jpt.channel_images(*_as(jnp.asarray, s["bj"]))
    ])
    bands_t = tpt.prepare_a_planes(*_as(T, s["aj"]), specs,
                                   n_bands=n_bands)
    b_planes_t = tpt.prepare_b_planes(*_as(T, s["bj"]), geom_t)
    cy, cx, cv = s["cand"]
    state_t = [tpt.to_compact(T(x), geom_t)
               for x in (s["off_y"], s["off_x"], s["dist"])]
    full_t = tpt.prepare_a_planes(*_as(T, s["aj"]), specs)
    owned_any = False
    for planes_j, band_j, planes_t, band_t in zip(
            bands_j, bounds_j, bands_t, tpt.band_bounds(ha, n_bands)):
        jo = jpt.tile_sweep(
            planes_j, b_blocked, jnp.asarray(cy.numpy()),
            jnp.asarray(cx.numpy()),
            jpt.to_blocked(jnp.asarray(s["off_y"]), geom_j),
            jpt.to_blocked(jnp.asarray(s["off_x"]), geom_j),
            jpt.to_blocked(jnp.asarray(s["dist"]), geom_j), band_j,
            jnp.asarray(cv.numpy()),
            specs=specs, geom=geom_j, ha=ha, wa=wa, coh_factor=coh,
            interpret=True,
        )
        want = [jpt.from_blocked(x, geom_j, h, w) for x in jo]
        got = tpt.tile_sweep(
            planes_t, b_planes_t, cy, cx, cv, *state_t,
            specs=specs, geom=geom_t, ha=ha, wa=wa, coh_factor=coh,
            band=band_t,
        )
        _assert_sweep_close(
            got, want, (T(s["off_y"]), T(s["off_x"]), T(s["dist"])),
            (full_t, b_planes_t), h, w, specs=specs, geom=geom_t, ha=ha,
            wa=wa)
        owned_any |= bool((got[2][:h, :w].numpy() != s["dist"]).any())
    assert owned_any


@pytest.mark.parametrize("n_bands,ha", [(2, 128), (4, 256)])
def test_band_sequence_equals_the_single_band_sweep(rng, n_bands, ha):
    s = _setup(rng, False, ha=ha)
    h, w, wa, specs, geom_t = s["h"], s["w"], s["wa"], s["specs"], \
        s["geom_t"]
    cy, cx, cv = s["cand"]
    b_planes = tpt.prepare_b_planes(*_as(T, s["bj"]), geom_t)
    kw = dict(specs=specs, geom=geom_t, ha=ha, wa=wa, coh_factor=1.0)
    z = torch.zeros((geom_t.n_ty * 64, geom_t.n_tx * geom_t.tile_w),
                    dtype=torch.int32)
    d0 = torch.full(z.shape, float("inf"))
    single = tpt.tile_sweep(tpt.prepare_a_planes(*_as(T, s["aj"]), specs),
                            b_planes, cy, cx, cv, z, z, d0, **kw)
    state = (z, z, d0)
    for planes, band in zip(
            tpt.prepare_a_planes(*_as(T, s["aj"]), specs, n_bands=n_bands),
            tpt.band_bounds(ha, n_bands)):
        state = tpt.tile_sweep(planes, b_planes, cy, cx, cv, *state,
                               band=band, **kw)
    for got, want in zip(state, single):
        assert torch.equal(got, want)
    assert bool(torch.isfinite(single[2]).all())


def test_short_band_planes_are_refused(rng):
    s = _setup(rng, False)
    specs, geom_t = s["specs"], s["geom_t"]
    cy, cx, cv = s["cand"]
    b_planes = tpt.prepare_b_planes(*_as(T, s["bj"]), geom_t)
    bands = tpt.prepare_a_planes(*_as(T, s["aj"]), specs, n_bands=2)
    z = torch.zeros((geom_t.n_ty * 64, geom_t.n_tx * geom_t.tile_w),
                    dtype=torch.int32)
    with pytest.raises(ValueError, match="band"):
        tpt.tile_sweep(bands[0][:, :40], b_planes, cy, cx, cv, z, z,
                       torch.zeros(z.shape), specs=specs, geom=geom_t,
                       ha=128, wa=128, coh_factor=1.0, band=(0, 64))

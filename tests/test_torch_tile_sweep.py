"""K1's plain version against the JAX kernel run in interpret mode
(`tile_sweep(..., interpret=True)`) on the same planes, candidate tables
(made from the JAX draws), incoming state and kappa factor, on the CPU:
at 128^2 fine-only and with the coarse channels, with mixed valid and
invalid slots and kappa > 1.

Distances agree to rtol 1e-4 / atol 1e-5 (the reference kernel tests'
tolerance); offsets are equal wherever the two winners are not within
that tolerance of each other."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels import patchmatch_tile as jpt
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt

from test_torch_tile import T, _as, _planes, jax_draws


def _assert_sweep_close(got, want, state_in, planes, h, w, **geo):
    """Distances within tolerance; offsets equal except at ties, where
    each side's offset reaches, under the port's per-pixel metric, a
    distance within tolerance of the other side's winner."""
    gy, gx, gd = (x.numpy()[:h, :w] for x in got)
    want = [T(np.array(x)) for x in want]
    wy, wx, wd = (x.numpy() for x in want)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-5)
    differ = (gy != wy) | (gx != wx)
    assert differ.mean() < 0.01
    for a, b in ((got, want), (want, got)):
        bad = tpt.unexplained_offsets(a, b, state_in, *planes, h=h, w=w,
                                      **geo)
        assert not bool(bad.any())


@pytest.mark.parametrize("coarse", [False, True])
def test_plain_sweep_against_jax_interpret(rng, coarse):
    h = w = ha = wa = 128
    coh = 1.7
    bj, aj = _planes(rng, h, w, ha, wa, coarse)
    specs = jpt.channel_specs(1, 1, JCfg(), coarse)
    geom_j = jpt.tile_geometry(h, w, specs)
    geom_t = tpt.tile_geometry(h, w, specs)
    (a_planes_j,) = jpt.prepare_a_planes(*_as(jnp.asarray, aj), specs)
    b_blocked = jnp.stack([
        jpt.to_blocked(c, geom_j)
        for c in jpt.channel_images(*_as(jnp.asarray, bj))
    ])
    a_planes_t = tpt.prepare_a_planes(*_as(T, aj), specs)
    b_planes_t = tpt.prepare_b_planes(*_as(T, bj), geom_t)

    # Incoming state: random matches, distances +inf on a third of the
    # pixels and otherwise in the candidates' own range.
    off_y = (rng.integers(0, ha, (h, w)) - np.arange(h)[:, None]).astype(
        np.int32)
    off_x = (rng.integers(0, wa, (h, w)) - np.arange(w)[None, :]).astype(
        np.int32)
    dist = (0.3 + 0.4 * rng.random((h, w))).astype(np.float32)
    dist[rng.random((h, w)) < 0.33] = np.inf
    key = jax.random.PRNGKey(11)
    cy, cx, cv = tpt.sample_candidates_blocked(
        tpt.to_compact(T(off_y), geom_t), tpt.to_compact(T(off_x), geom_t),
        jax_draws(key, 0, geom_t, ha, wa), geom_t, ha, wa)
    cv = cv * T((rng.random(cv.shape) > 0.3).astype(np.int32))
    assert 0 < cv.float().mean() < 1
    jo = jpt.tile_sweep(
        a_planes_j, b_blocked, jnp.asarray(cy.numpy()),
        jnp.asarray(cx.numpy()),
        jpt.to_blocked(jnp.asarray(off_y), geom_j),
        jpt.to_blocked(jnp.asarray(off_x), geom_j),
        jpt.to_blocked(jnp.asarray(dist), geom_j), None,
        jnp.asarray(cv.numpy()),
        specs=specs, geom=geom_j, ha=ha, wa=wa, coh_factor=coh,
        interpret=True,
    )
    want = [jpt.from_blocked(x, geom_j, h, w) for x in jo]
    got = tpt.tile_sweep(
        a_planes_t, b_planes_t, cy, cx, cv,
        tpt.to_compact(T(off_y), geom_t), tpt.to_compact(T(off_x), geom_t),
        tpt.to_compact(T(dist), geom_t),
        specs=specs, geom=geom_t, ha=ha, wa=wa, coh_factor=coh,
    )
    _assert_sweep_close(got, want, (T(off_y), T(off_x), T(dist)),
                        (a_planes_t, b_planes_t), h, w, specs=specs,
                        geom=geom_t, ha=ha, wa=wa)
    # Both minima and the kappa merge took part.
    assert (got[2].numpy()[:h, :w] != dist).mean() > 0.5

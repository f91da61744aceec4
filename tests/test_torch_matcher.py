"""The port's matcher core against the JAX package on the same numpy inputs:
the field helpers and distances, the exact-NN oracle (plain K2 version
against JAX `exact_nn` and the interpreted Pallas kernel), the coherence
pass on an injected field, and the per-pixel PatchMatch sweeps fed the
JAX random draws.  All on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.kernels.nn_brute import exact_nn_pallas
from image_analogies_tpu.models import brute as j_brute
from image_analogies_tpu.models import coherence as j_coh
from image_analogies_tpu.models import matcher as j_m
from image_analogies_tpu.models import patchmatch as j_pm
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.kernels import nn_brute as t_nb
from image_analogies_tpu_torch.models import brute as t_brute
from image_analogies_tpu_torch.models import coherence as t_coh
from image_analogies_tpu_torch.models import matcher as t_m
from image_analogies_tpu_torch.models import patchmatch as t_pm

T = torch.from_numpy


def nnf(rng, h, w, ha, wa):
    return np.stack(
        [rng.integers(0, ha, (h, w)), rng.integers(0, wa, (h, w))], -1
    ).astype(np.int32)


def test_field_helpers(rng):
    field = nnf(rng, 9, 11, 13, 17) + np.int32(3)
    np.testing.assert_array_equal(
        t_m.clamp_nnf(T(field).long(), 13, 17).numpy(),
        np.asarray(j_m.clamp_nnf(jnp.asarray(field), 13, 17)),
    )
    field = nnf(rng, 9, 11, 13, 17)
    flat = t_m.nnf_to_flat(T(field).long(), 17)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(j_m.nnf_to_flat(jnp.asarray(field), 17))
    )
    np.testing.assert_array_equal(
        t_m.flat_to_nnf(flat, 17, (9, 11)).numpy(), field
    )


@pytest.mark.parametrize("wider_a", [False, True])
def test_candidate_and_nnf_dist(rng, wider_a):
    f_b = rng.random((9, 11, 20)).astype(np.float32)
    f_a = rng.random((13, 17, 20)).astype(np.float32)
    a_flat = f_a.reshape(-1, 20)
    if wider_a:  # zero pad columns, sliced to the B width
        a_flat = np.pad(a_flat, ((0, 0), (0, 12)))
    field = nnf(rng, 9, 11, 13, 17)
    idx = field[..., 0] * 17 + field[..., 1]
    np.testing.assert_allclose(
        t_m.candidate_dist(T(f_b.reshape(-1, 20)), T(a_flat),
                           T(idx.reshape(-1)).long()).numpy(),
        np.asarray(j_m.candidate_dist(jnp.asarray(f_b.reshape(-1, 20)),
                                      jnp.asarray(a_flat),
                                      jnp.asarray(idx.reshape(-1)))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        t_m.nnf_dist(T(f_b), T(a_flat), T(field).long(), 17).numpy(),
        np.asarray(j_m.nnf_dist(jnp.asarray(f_b), jnp.asarray(a_flat),
                                jnp.asarray(field), 17)),
        rtol=1e-5, atol=1e-6,
    )


def _assert_argmin_equal_but_ties(f_b, f_a, idx_t, idx_j):
    idx_t, idx_j = np.asarray(idx_t), np.asarray(idx_j)
    diff = idx_t != idx_j
    if diff.any():
        d = lambda i: ((f_b[diff] - f_a[i[diff]]) ** 2).sum(-1)  # noqa: E731
        np.testing.assert_allclose(d(idx_t), d(idx_j), rtol=1e-5)
    assert diff.mean() < 0.01


@pytest.mark.parametrize("n_b,n_a,d", [(300, 700, 68), (129, 1030, 40)])
def test_exact_nn_against_jax(rng, n_b, n_a, d):
    f_b = rng.random((n_b, d)).astype(np.float32)
    f_a = rng.random((n_a, d)).astype(np.float32)
    idx_t, dist_t = t_brute.exact_nn(T(f_b), T(f_a), chunk=128)
    idx_j, dist_j = j_brute.exact_nn(jnp.asarray(f_b), jnp.asarray(f_a),
                                     chunk=128)
    idx_k, dist_k = exact_nn_pallas(jnp.asarray(f_b), jnp.asarray(f_a),
                                    interpret=True)
    for idx_r, dist_r in ((idx_j, dist_j), (idx_k, dist_k)):
        _assert_argmin_equal_but_ties(f_b, f_a, idx_t.numpy(), idx_r)
        np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_r),
                                   rtol=1e-5, atol=1e-6)


def test_exact_nn_first_index_ties(rng):
    """Duplicate A rows across tile boundaries: the lowest flat index wins,
    as in the reference kernel's test."""
    base = rng.standard_normal((600, 32)).astype(np.float32)
    base[550] = base[3]
    f_b = base[[3, 550, 100]]
    idx_t, _ = t_brute.exact_nn(T(f_b), T(base), chunk=2)
    idx_k, _ = exact_nn_pallas(jnp.asarray(f_b), jnp.asarray(base),
                               interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_k))
    assert idx_t.tolist()[:2] == [3, 3]


def test_nn_argmin_plain_all_ties():
    """A constant table: every row ties, so every query takes row 0."""
    f_a = torch.ones(50, 8)
    idx = t_nb.nn_argmin(torch.ones(7, 8), f_a, chunk=3)
    assert idx.tolist() == [0] * 7


def test_brute_matcher_against_jax(rng):
    f_b = rng.random((12, 13, 20)).astype(np.float32)
    f_a = rng.random((9, 11, 20)).astype(np.float32)
    n0 = np.zeros((12, 13, 2), np.int32)
    nnf_t, dist_t = t_m.get_matcher("brute").match(
        T(f_b), T(f_a), T(n0).long(), level=0, cfg=TCfg(device="cpu",
                                                          matcher="brute"))
    nnf_j, dist_j = j_m.get_matcher("brute").match(
        jnp.asarray(f_b), jnp.asarray(f_a), jnp.asarray(n0),
        key=jax.random.PRNGKey(0), level=0,
        cfg=JCfg(matcher="brute", pallas_mode="off"))
    np.testing.assert_array_equal(nnf_t.numpy(), np.asarray(nnf_j))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=1e-5)


@pytest.mark.parametrize("factor", [1.0, 1.5, 3.0])
def test_coherence_sweeps_injected_field(rng, factor):
    h, w, ha, wa, d = 14, 15, 16, 18, 12
    f_b = rng.random((h, w, d)).astype(np.float32)
    f_a = rng.random((ha, wa, d)).astype(np.float32)
    field = nnf(rng, h, w, ha, wa)
    dist = np.asarray(j_m.nnf_dist(jnp.asarray(f_b),
                                   jnp.asarray(f_a.reshape(-1, d)),
                                   jnp.asarray(field), wa))
    nnf_t, d_t = t_coh.coherence_sweeps(
        T(f_b), T(f_a), T(field).long(), T(dist.copy()), factor=factor,
        sweeps=2)
    nnf_j, d_j = j_coh.coherence_sweeps(
        jnp.asarray(f_b), jnp.asarray(f_a), jnp.asarray(field),
        jnp.asarray(dist), factor=factor, sweeps=2)
    np.testing.assert_array_equal(nnf_t.numpy(), np.asarray(nnf_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    if factor > 1.0:
        assert (nnf_t.numpy() != field).any()


def _jax_sweep_offsets(key, iters, radii, h, w):
    """The draws `patchmatch_sweeps` makes, by its own key derivation."""
    out = []
    for it_key in jax.random.split(key, iters):
        keys = jax.random.split(it_key, len(radii))
        out.append(torch.stack([
            T(np.array(jax.random.randint(rk, (h, w, 2), -r, r + 1)))
            for r, rk in zip(radii, keys)
        ]).long())
    return out


@pytest.mark.parametrize("coh", [1.0, 2.0])
def test_patchmatch_sweeps_given_jax_draws(rng, coh):
    h, w, ha, wa, d = 20, 22, 24, 26, 18
    f_b = rng.random((h, w, d)).astype(np.float32)
    f_a = rng.random((ha, wa, d)).astype(np.float32)
    field = nnf(rng, h, w, ha, wa)
    key = jax.random.PRNGKey(7)
    iters, n_random = 3, 4
    radii = t_pm.sweep_radii(ha, wa, n_random)
    nnf_j, d_j = j_pm.patchmatch_sweeps(
        jnp.asarray(f_b), jnp.asarray(f_a), jnp.asarray(field), key,
        iters=iters, n_random=n_random, coh_factor=coh)
    nnf_t, d_t = t_pm.patchmatch_sweeps(
        T(f_b), T(f_a), T(field).long(),
        _jax_sweep_offsets(key, iters, radii, h, w), coh_factor=coh)
    same = (nnf_t.numpy() == np.asarray(nnf_j)).all(-1)
    assert same.mean() > 0.99
    np.testing.assert_allclose(d_t.numpy()[same], np.asarray(d_j)[same],
                               rtol=1e-5)


def test_kappa_factor_and_schedules():
    for kappa in (0.0, 2.0):
        for level in range(4):
            assert t_pm.kappa_factor(kappa, level) == j_pm.kappa_factor(
                kappa, level)
    for ha in (1024, 4096):
        tc, jc = TCfg(device="cpu"), JCfg()
        assert t_pm._pm_iters_for(tc, ha, ha) == j_pm._pm_iters_for(jc, ha, ha)
        assert t_pm._polish_schedule_for(tc, ha, ha, 1) == \
            j_pm._polish_schedule_for(jc, ha, ha, 1)

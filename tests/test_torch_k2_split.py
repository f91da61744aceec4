"""K2's float32 route on the CPU: the plain version's emulation of the
kernel's arithmetic (rows split into two TF32 parts, three products)
against the float32 argmin and the JAX kernel in interpret mode, on
seeded tables and on the port's own level-0 feature tables; why one TF32
product is not enough; and that padding the feature width with zeros
cannot move the argmin; and config 1 end to end with the split in the
matcher's place against the JAX package.

Two picks for a query are a tie when their exact distances (direct
subtraction, float64) agree within 1e-5 relative; picks may differ only
at ties, because sums in another order round differently."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from image_analogies_tpu import SynthConfig as JCfg
from image_analogies_tpu import create_image_analogy as j_create
from image_analogies_tpu.kernels.nn_brute import exact_nn_pallas
from image_analogies_tpu_torch import create_image_analogy, psnr
from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.kernels import nn_brute as nb
from image_analogies_tpu_torch.models import brute
from image_analogies_tpu_torch.utils.examples import texture_by_numbers

T = torch.from_numpy


def exact_dist(f_b, f_a, idx):
    diff = f_b.astype(np.float64) - f_a[np.asarray(idx)].astype(np.float64)
    return (diff * diff).sum(-1)


def off_ties(f_b, f_a, idx, idx_ref):
    """Rows where `idx` differs from `idx_ref` and the two are no tie."""
    idx, idx_ref = np.asarray(idx), np.asarray(idx_ref)
    d, d_ref = exact_dist(f_b, f_a, idx), exact_dist(f_b, f_a, idx_ref)
    return (idx != idx_ref) & (np.abs(d - d_ref) > 1e-5 * np.abs(d_ref))


def seeded_tables(n_b, n_a, d):
    rng = np.random.default_rng(n_b * 31 + n_a * 7 + d)
    return (rng.random((n_b, d)).astype(np.float32),
            rng.random((n_a, d)).astype(np.float32))


def level0_tables():
    """The feature tables the brute matcher sees at the finest level of
    texture_by_numbers(32), captured at its call of `nn_argmin`."""
    seen = []
    real = brute.nn_argmin

    def spy(f_b, f_a, *args, **kw):
        seen.append((f_b.numpy().copy(), f_a.numpy().copy()))
        return real(f_b, f_a, *args, **kw)

    brute.nn_argmin = spy
    try:
        create_image_analogy(*texture_by_numbers(32), SynthConfig(
            levels=2, matcher="brute", em_iters=1, device="cpu"))
    finally:
        brute.nn_argmin = real
    return seen[-1]


def test_tf32_round_is_round_to_nearest_on_10_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-11 - 2.0**-20,
                      -1.0 - 2.0**-11, 3.0 + 2.0**-9, 0.0, 2.0**-30])
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0, -1.0 - 2.0**-10,
                         3.0 + 2.0**-9, 0.0, 2.0**-30])
    assert torch.equal(nb.tf32_round(x), want)
    hi, lo = nb.split_tf32(x)
    assert torch.equal(nb.tf32_round(hi), hi)
    assert torch.equal(nb.tf32_round(lo), lo)
    # hi + lo keeps about 21 mantissa bits of x.
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0**-21 * x.double().abs()).all())


@pytest.mark.parametrize("n_b,n_a,d", [(300, 700, 68), (129, 1030, 150),
                                       (257, 513, 68), (64, 2001, 150)])
def test_split_argmin_equals_f32_argmin_off_ties(n_b, n_a, d):
    f_b, f_a = seeded_tables(n_b, n_a, d)
    a_sq = nb.squared_norms(T(f_a))
    idx3 = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq, chunk=100, tf32_passes=3)
    idx0 = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq, chunk=100)
    assert not off_ties(f_b, f_a, idx3, idx0).any()
    assert (idx3 != idx0).float().mean() < 0.01


@pytest.mark.parametrize("n_b,n_a,d", [(300, 700, 68), (129, 1030, 150)])
def test_split_argmin_equals_jax_kernel_off_ties(n_b, n_a, d):
    f_b, f_a = seeded_tables(n_b, n_a, d)
    idx3 = nb.nn_argmin_plain(T(f_b), T(f_a), nb.squared_norms(T(f_a)),
                              chunk=128, tf32_passes=3)
    idx_j, _ = exact_nn_pallas(jnp.asarray(f_b), jnp.asarray(f_a),
                               interpret=True)
    assert not off_ties(f_b, f_a, idx3, idx_j).any()


def test_split_argmin_on_level0_feature_tables():
    f_b, f_a = level0_tables()
    assert f_b.shape[0] == 32 * 32 and f_b.shape[1] == f_a.shape[1]
    a_sq = nb.squared_norms(T(f_a))
    idx3 = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq, tf32_passes=3)
    idx0 = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq)
    idx_j, _ = exact_nn_pallas(jnp.asarray(f_b), jnp.asarray(f_a),
                               interpret=True)
    assert not off_ties(f_b, f_a, idx3, idx0).any()
    assert not off_ties(f_b, f_a, idx3, idx_j).any()


def near_tie_table(d):
    """64 queries, each 55 % of the way from an A row a0 to a second row
    a1 = a0 + eps: the two distances differ by a third, far outside the
    tie rule and the float32 rounding of the expansion, and far inside
    the rounding of one TF32 product."""
    rng = np.random.default_rng(d)
    a0 = rng.random((64, d)).astype(np.float32)
    eps = (3e-3 * rng.standard_normal((64, d))).astype(np.float32)
    f_a = np.concatenate([a0, a0 + eps]).astype(np.float32)
    f_b = (a0 + np.float32(0.55) * eps).astype(np.float32)
    return f_b, f_a


def one_pass_argmin(f_b, f_a, a_sq):
    """The argmin with a single TF32 product per pair: what a tensor-core
    kernel without the split would compute."""
    dot = nb.tf32_round(f_b) @ nb.tf32_round(f_a).T
    return torch.argmin(a_sq[None, :] - 2.0 * dot, dim=-1)


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
@pytest.mark.parametrize("d", [68, 150])
def test_one_tf32_pass_misses_near_ties_and_the_split_does_not(d, passes,
                                                               meets):
    f_b, f_a = near_tie_table(d)
    a_sq = nb.squared_norms(T(f_a))
    idx0 = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq)
    # float32 resolves every pair: the nearer row is a1 = row 64 + q.
    assert idx0.tolist() == list(range(64, 128))
    if passes == 3:
        idx = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq, tf32_passes=3)
    else:
        idx = one_pass_argmin(T(f_b), T(f_a), a_sq)
    assert (not off_ties(f_b, f_a, idx, idx0).any()) == meets


@pytest.mark.parametrize("dtype,passes", [(torch.float32, 0),
                                          (torch.float32, 3),
                                          (torch.bfloat16, 0)])
@pytest.mark.parametrize("n_b,n_a,d", [(200, 333, 68), (77, 1025, 150)])
def test_zero_padding_the_width_cannot_move_the_argmin(n_b, n_a, d, dtype,
                                                       passes):
    f_b, f_a = seeded_tables(n_b, n_a, d)
    a_sq = nb.squared_norms(T(f_a))
    d_pad = nb.padded_dim(d, dtype)
    assert d_pad % (8 if dtype == torch.float32 else 16) == 0
    assert d <= d_pad < d + 16
    idx = nb.nn_argmin_plain(T(f_b), T(f_a), a_sq, match_dtype=dtype,
                             tf32_passes=passes)
    idx_pad = nb.nn_argmin_plain(
        F.pad(T(f_b), (0, d_pad - d)), F.pad(T(f_a), (0, d_pad - d)), a_sq,
        match_dtype=dtype, tf32_passes=passes)
    assert torch.equal(idx, idx_pad)


@pytest.mark.parametrize("d,dtype,want", [
    (68, torch.float32, 72), (68, torch.bfloat16, 80),
    (150, torch.float32, 152), (150, torch.bfloat16, 160),
    (8, torch.float32, 8), (256, torch.bfloat16, 256),
])
def test_padded_dim(d, dtype, want):
    assert nb.padded_dim(d, dtype) == want


@pytest.mark.parametrize("passes", [1, 2])
def test_plain_rejects_unknown_pass_count(passes):
    f = torch.ones(4, 8)
    with pytest.raises(ValueError, match="tf32_passes"):
        nb.nn_argmin_plain(f, f, nb.squared_norms(f), tf32_passes=passes)


def test_config1_with_the_split_argmin_against_jax(monkeypatch):
    """Config 1 (texture-by-numbers, brute, 3 levels, 2 EM steps) at 48^2
    with the card's float32 arithmetic, the three TF32 passes, in the
    matcher's place on the CPU, against the JAX package.  The split flips
    near-ties, so B' is held by PSNR (the float32 matmul path's own gate
    against JAX is 40 dB).  The run's picks are held against the exact
    nearest rows (float64): a pick may exceed the least distance by 1e-5
    relative plus 8 float32 ulps of ||a||^2 + ||b||^2, the resolution of
    the expansion a_sq - 2 b.a that the split, the float32 matmul and
    the JAX kernel all minimize (on feature tables of neighbouring
    pixels the distance is a thousandth of that scale, so 1e-5 relative
    alone is finer than any of them resolves); the float32 matmul's
    picks on the same tables are held to the same rule."""
    calls = []
    plain = nb.nn_argmin_plain

    def split_plain(f_b, f_a, a_sq, chunk=4096,
                    match_dtype=torch.float32):
        idx = plain(f_b, f_a, a_sq, chunk, match_dtype, tf32_passes=3)
        calls.append((f_b.numpy(), f_a.numpy(), idx.numpy(),
                      plain(f_b, f_a, a_sq, chunk, match_dtype).numpy()))
        return idx

    monkeypatch.setattr(nb, "nn_argmin_plain", split_plain)
    a, ap, b = texture_by_numbers(48)
    kw = dict(levels=3, matcher="brute", em_iters=2)
    got = create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw))
    want = np.asarray(j_create(a, ap, b, JCfg(**kw)))
    assert calls
    for f_b, f_a, idx3, idx0 in calls:
        b64, a64 = f_b.astype(np.float64), f_a.astype(np.float64)
        least = ((b64 * b64).sum(-1)[:, None] + (a64 * a64).sum(-1)[None]
                 - 2.0 * b64 @ a64.T).min(-1).clip(0.0)
        for idx in (idx3, idx0):
            excess = exact_dist(f_b, f_a, idx) - least
            scale = (a64[idx] ** 2).sum(-1) + (b64 * b64).sum(-1)
            assert (excess <= 1e-5 * least + 8 * 2.0**-23 * scale).all()
    assert got.shape == b.shape and float(got.std()) > 0.05
    assert psnr(got.numpy(), want) >= 40.0

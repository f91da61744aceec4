"""K3's plain version, the polish tables and the polish engines against
the JAX package, on the CPU: the row gather against JAX
`gather_rows(interpret=True)` (bitwise, bf16 and int8 tables, ragged and
multi-block M, leading axes, out-of-range clamping), the padded and the
quantized tables (bitwise), the streamed and int8 fetches inside
`candidate_dist` (bitwise against the port's own `index_select` path,
rtol 1e-6 against JAX's `_polish_gather_fn`), the sequential cascade
under the stream hook (bitwise), and the jump polish given the JAX draws
(fields equal except at float ties, distances rtol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.kernels import polish_stream as jps
from image_analogies_tpu.models import matcher as j_m
from image_analogies_tpu.models import patchmatch as j_pm
from image_analogies_tpu_torch.kernels import polish_stream as tps
from image_analogies_tpu_torch.models import matcher as t_m
from image_analogies_tpu_torch.models import patchmatch as t_pm

T = torch.from_numpy


def bf16_pair(x: np.ndarray):
    """The same float32 numbers as a JAX and a torch bfloat16 array."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = T(np.asarray(j).view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def bits(x) -> np.ndarray:
    """The raw bits of a torch or JAX array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _tables(rng, na, dtype, d=68):
    """A (na, d) table as JAX and torch arrays of `dtype` ("bf16" or
    "int8"), already LANE-padded by each package's own helper."""
    x = rng.random((na, d), dtype=np.float32)
    if dtype == "bf16":
        tj, tt = bf16_pair(x)
    else:
        q = rng.integers(-127, 128, (na, d)).astype(np.int8)
        tj, tt = jnp.asarray(q), T(q)
    return jps.prepare_polish_table(tj), tps.prepare_polish_table(tt)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("na,idx_shape,rows_per_block", [
    (120, (100,), None),    # one block
    (97, (203,), 16),       # several blocks, ragged last one
    (50, (3, 40), 32),      # leading axes flatten in order
])
def test_gather_rows_plain_against_jax(rng, dtype, na, idx_shape,
                                       rows_per_block):
    tab_j, tab_t = _tables(rng, na, dtype)
    idx = rng.integers(0, na, idx_shape).astype(np.int32)
    want = jps.gather_rows(tab_j, jnp.asarray(idx), interpret=True,
                           rows_per_block=rows_per_block)
    got = tps.gather_rows(tab_t, T(idx).long())
    assert tuple(got.shape) == (idx.size, tps.LANE)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_rows_clamps_out_of_range(rng, dtype):
    tab_j, tab_t = _tables(rng, 40, dtype)
    idx = np.array([0, 39, 40, 1000, -3], np.int32)
    want = jps.gather_rows(tab_j, jnp.asarray(idx), interpret=True)
    got = tps.gather_rows(tab_t, T(idx))
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got[3]), bits(tab_t[39]))
    np.testing.assert_array_equal(bits(got[4]), bits(tab_t[0]))


def test_gather_rows_rejects_unpadded_table(rng):
    _, t = bf16_pair(rng.random((10, 68), dtype=np.float32))
    with pytest.raises(ValueError, match="LANE-padded"):
        tps.gather_rows(t, torch.zeros(4, dtype=torch.long))


def test_prepare_polish_table_zero_pad(rng):
    tj, tt = bf16_pair(rng.random((33, 68), dtype=np.float32))
    got, want = tps.prepare_polish_table(tt), jps.prepare_polish_table(tj)
    assert tuple(got.shape) == (33, tps.LANE) and got.is_contiguous()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (got[:, 68:].float() == 0).all()
    assert tps.prepare_polish_table(got) is got
    with pytest.raises(ValueError):
        tps.prepare_polish_table(torch.zeros(3, tps.LANE + 1))


def test_quantize_rows_against_jax(rng):
    x = (rng.normal(0, 3.0, (40, 20)) * np.linspace(0.01, 5.0, 40)[:, None])
    tj, tt = bf16_pair(x.astype(np.float32))
    q_t, s_t = tps.quantize_rows(tt)
    q_j, s_j = jps.quantize_rows(tj)
    assert q_t.dtype == torch.int8 and tuple(s_t.shape) == (40, 1)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.int32),
                                  np.asarray(s_j).view(np.int32))
    q0, s0 = tps.quantize_rows(torch.zeros(3, 8, dtype=torch.bfloat16))
    assert int(q0.abs().sum()) == 0 and torch.isfinite(s0).all()


def test_byte_model_and_eval_rows_match_reference():
    for args in [(68,), (128,), (129,), (68, 1, "int8"), (200, 4)]:
        assert tps.polish_dma_bytes_per_fetch(*args) == \
            jps.polish_dma_bytes_per_fetch(*args)
    with pytest.raises(ValueError):
        tps.polish_dma_bytes_per_fetch(0)
    for args in [(100, 1, 4), (100, 2, 2), (7, 0, 3)]:
        assert tps.polish_eval_rows(*args) == jps.polish_eval_rows(*args)


def _dist_inputs(rng, na=256, nb=256, d=68):
    a_j, a_t = bf16_pair(rng.random((na, d), dtype=np.float32))
    b_j, b_t = bf16_pair(rng.random((nb, d), dtype=np.float32))
    idx = rng.integers(0, na, nb).astype(np.int32)
    return (a_j, b_j, jnp.asarray(idx)), (a_t, b_t, T(idx).long())


def test_stream_and_take_distances_bitwise(rng):
    """The bf16 stream fetch (padded rows, sliced back) gives the same
    distances, bit for bit, as `index_select`, and matches JAX."""
    (a_j, b_j, i_j), (a_t, b_t, i_t) = _dist_inputs(rng)
    take = t_m.candidate_dist(b_t, a_t, i_t)
    stream = t_m.candidate_dist(
        b_t, a_t, i_t, gather_fn=t_pm._stream_gather_fn(a_t, True))
    np.testing.assert_array_equal(stream.numpy(), take.numpy())
    np.testing.assert_allclose(
        take.numpy(), np.asarray(j_m.candidate_dist(b_j, a_j, i_j)),
        rtol=1e-6)


def test_int8_engines_against_jax(rng, monkeypatch):
    """int8 rows through `index_select` and through K3's path: bitwise
    equal in the port, and within rtol 1e-6 of JAX's engines."""
    from image_analogies_tpu.kernels import patchmatch_tile as jpt

    (a_j, b_j, i_j), (a_t, b_t, i_t) = _dist_inputs(rng, na=96, nb=64)
    monkeypatch.setattr(jpt, "_CAND_DTYPE", "int8")
    got = {}
    for mode in ("sequential", "stream"):
        gf = t_pm._polish_gather_fn(a_t, True, "int8", mode)
        got[mode] = t_m.candidate_dist(b_t, a_t, i_t, gather_fn=gf)
        monkeypatch.setattr(j_pm, "_POLISH_MODE", mode)
        want = j_m.candidate_dist(
            b_j, a_j, i_j, gather_fn=j_pm._polish_gather_fn(a_j, 68, True))
        np.testing.assert_allclose(got[mode].numpy(), np.asarray(want),
                                   rtol=1e-6)
    np.testing.assert_array_equal(got["stream"].numpy(),
                                  got["sequential"].numpy())
    exact = t_m.candidate_dist(b_t, a_t, i_t)
    np.testing.assert_allclose(got["stream"].numpy(), exact.numpy(),
                               rtol=0.15, atol=0.05)


def test_bf16_engines_are_the_default_and_k3(rng):
    _, (a_t, _, _) = _dist_inputs(rng, na=64, nb=8)
    assert t_pm._polish_gather_fn(a_t, True, "bf16", "sequential") is None
    assert t_pm._polish_gather_fn(a_t, True, "bf16", "stream") is not None
    assert t_pm._polish_gather_fn(a_t, True, "int8", "sequential") is not None


def test_sweeps_bitwise_under_stream_hook(rng):
    """The sequential cascade with the streamed fetch: same draws, same
    accepts, field and distances bitwise equal."""
    h = w = 16
    f_b = bf16_pair(rng.random((h, w, 4), dtype=np.float32))[1]
    f_a = bf16_pair(rng.random((h, w, 4), dtype=np.float32))[1]
    nnf0 = torch.zeros(h, w, 2, dtype=torch.long)
    gen = torch.Generator().manual_seed(3)
    offs = list(t_pm.sweep_offsets(gen, 2, t_pm.sweep_radii(h, w, 2), h, w))
    n_s, d_s = t_pm.patchmatch_sweeps(f_b, f_a, nnf0, offs, coh_factor=1.0)
    gf = t_pm._stream_gather_fn(f_a.reshape(-1, 4), True)
    n_t, d_t = t_pm.patchmatch_sweeps(f_b, f_a, nnf0, offs, coh_factor=1.0,
                                      gather_fn=gf)
    assert torch.equal(n_s, n_t) and torch.equal(d_s, d_t)


def test_candidate_dist_lean_matches_candidate_dist(rng):
    (_, _, _), (a_t, b_t, _) = _dist_inputs(rng, na=300, nb=200)
    idx = T(rng.integers(0, 300, (5, 200))).long()
    lean = t_m.candidate_dist_lean(b_t, a_t, idx, chunk=64)
    assert tuple(lean.shape) == (5, 200)
    for k in range(5):
        np.testing.assert_allclose(
            lean[k].numpy(), t_m.candidate_dist(b_t, a_t, idx[k]).numpy(),
            rtol=1e-6)
    np.testing.assert_allclose(
        t_m.candidate_dist_lean(b_t, a_t, idx[0]).numpy(),
        lean[0].numpy(), rtol=1e-6)


def _jax_jump_offsets(key, iters, radii, h, w):
    """The draws `polish_sweeps_planes` makes, by its own key derivation:
    per sweep and radius, one (H, W) draw for y and one for x."""
    out = []
    for it_key in jax.random.split(key, iters):
        per = []
        keys = jax.random.split(it_key, len(radii)) if radii else []
        for r, rk in zip(radii, keys):
            ky, kx = jax.random.split(rk)
            per.append(np.stack([
                np.array(jax.random.randint(ky, (h, w), -r, r + 1)),
                np.array(jax.random.randint(kx, (h, w), -r, r + 1)),
            ], -1))
        out.append(T(np.stack(per)).long() if per
                   else torch.zeros(0, h, w, 2, dtype=torch.long))
    return out


@pytest.mark.parametrize("coh,n_random", [(1.0, 3), (2.0, 2), (1.0, 0)])
def test_jump_polish_given_jax_draws(rng, coh, n_random):
    h, w, ha, wa, d = 24, 26, 28, 30, 12
    bj, bt = bf16_pair(rng.random((h, w, d), dtype=np.float32))
    aj, at = bf16_pair(rng.random((ha, wa, d), dtype=np.float32))
    field = np.stack([rng.integers(0, ha, (h, w)),
                      rng.integers(0, wa, (h, w))], -1).astype(np.int32)
    dist = np.asarray(j_m.nnf_dist(bj, aj.reshape(-1, d),
                                   jnp.asarray(field), wa))
    key = jax.random.PRNGKey(5)
    iters = 2
    nnf_j, d_j = j_pm.polish_sweeps(
        bj, aj, jnp.asarray(field), jnp.asarray(dist), key, iters=iters,
        n_random=n_random, coh_factor=coh)
    offs = _jax_jump_offsets(key, iters, t_pm.sweep_radii(ha, wa, n_random),
                             h, w)
    nnf_t, d_t = t_pm.polish_sweeps(bt, at, T(field).long(), T(dist.copy()),
                                    offs, coh_factor=coh)
    nnf_j, d_j = np.asarray(nnf_j), np.asarray(d_j)
    same = (nnf_t.numpy() == nnf_j).all(-1)
    assert same.mean() > 0.99
    # Where the fields differ, the two matches tie in the metric.
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5)
    assert (nnf_t.numpy() != field).any()


def test_lex_min_ties_to_lowest_index():
    d = torch.tensor([[1.0, 2.0], [1.0, 0.5], [3.0, 0.5]])
    idx = torch.tensor([[7, 1], [3, 9], [2, 4]])
    d_min, i_min = t_pm._lex_min(d, idx)
    assert d_min.tolist() == [1.0, 0.5] and i_min.tolist() == [3, 4]


def test_polish_mode_setter_and_env_default(monkeypatch):
    assert t_pm._POLISH_MODE == j_pm._POLISH_MODE
    assert t_pm._POLISH_MODES == j_pm._POLISH_MODES
    assert t_pm._TIE_FLOOD_STEPS == j_pm._TIE_FLOOD_STEPS
    assert t_pm._JUMP_STEPS == j_pm._JUMP_STEPS
    monkeypatch.setattr(t_pm, "_POLISH_MODE", "sequential")
    t_pm.set_polish_mode("stream")
    assert t_pm._POLISH_MODE == "stream"
    with pytest.raises(ValueError, match="polish mode"):
        t_pm.set_polish_mode("turbo")
    assert t_pm._POLISH_MODE == "stream"

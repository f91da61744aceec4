"""The port's lean path (levels past the feature-table budgets) against the
JAX package and against its own standard path, on the CPU: slab-assembled
bf16 tables (bit-equal to the whole-image assembly cast to bf16, within
one bf16 ulp of JAX's), the plane-pair field helpers, the lean coherence
and PatchMatch sweeps given the JAX draws, the level plans at the
reference's sizes, lean PatchMatch end to end at 128^2 against the brute
oracle (the reference tests' bars), the lean-brute oracle against the
JAX lean-brute B' and the standard oracle, B-side banding, kappa, and
the compressed modes at a lean level."""

import logging
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu import SynthConfig as JCfg
from image_analogies_tpu import create_image_analogy as j_create
from image_analogies_tpu.models import analogy as jan
from image_analogies_tpu.models import coherence as j_coh
from image_analogies_tpu.models import matcher as j_match
from image_analogies_tpu.models import patchmatch as j_pm
from image_analogies_tpu.utils.examples import super_resolution
from image_analogies_tpu_torch import SynthConfig, create_image_analogy, psnr
from image_analogies_tpu_torch.kernels import patchmatch_tile as tpt
from image_analogies_tpu_torch.models import analogy as tan
from image_analogies_tpu_torch.models import coherence as t_coh
from image_analogies_tpu_torch.models import patchmatch as t_pm
from image_analogies_tpu_torch.models.matcher import candidate_dist_lean
from image_analogies_tpu_torch.ops.features import assemble_features
from image_analogies_tpu_torch.parallel import spatial as t_sp

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and a full thread pool in each would oversubscribe
    the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(a, ap, b, aux=False, **kw):
    return create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw),
                                return_aux=aux)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_slab_helpers_equal_jax(rng):
    from image_analogies_tpu.parallel import spatial as j_sp

    for kw in ({}, dict(patch_size=7), dict(patch_size=3,
                                            coarse_patch_size=5)):
        assert t_sp.slab_halo(SynthConfig(**kw)) == j_sp.slab_halo(JCfg(**kw))
    x = rng.random((24, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_sp._split_slabs(T(x), 4, 2).numpy(),
        np.asarray(j_sp._split_slabs(jnp.asarray(x), 4, 2)))


@pytest.mark.parametrize("h,w,coarse,rows", [(37, 40, True, 8),
                                             (40, 24, False, 16),
                                             (52, 16, True, 16),
                                             (30, 20, True, 256)])
def test_assemble_features_lean(rng, monkeypatch, h, w, coarse, rows):
    """Bit-equal to the whole-image assembly cast to bf16, with several
    slabs and edge padding; within one bf16 ulp of JAX's lean table."""
    monkeypatch.setattr(tan, "_LEAN_CHUNK_ROWS", rows)
    monkeypatch.setattr(jan, "_LEAN_CHUNK_ROWS", rows)
    cfg = SynthConfig(device="cpu")
    src, flt = (rng.random((h, w)).astype(np.float32) for _ in range(2))
    hc, wc = (h + 1) // 2, (w + 1) // 2
    src_c = flt_c = None
    if coarse:
        src_c, flt_c = (rng.random((hc, wc)).astype(np.float32)
                        for _ in range(2))
    opt = (lambda x: None if x is None else T(x))
    got = tan.assemble_features_lean(T(src), T(flt), cfg, opt(src_c),
                                     opt(flt_c))
    assert got.dtype == torch.bfloat16 and got.shape[0] == h * w
    whole = assemble_features(T(src), T(flt), cfg, opt(src_c), opt(flt_c))
    assert torch.equal(got, whole.reshape(h * w, -1).to(torch.bfloat16))
    jopt = (lambda x: None if x is None else jnp.asarray(x))
    want = np.asarray(jan.assemble_features_lean(
        jnp.asarray(src), jnp.asarray(flt), JCfg(), jopt(src_c), jopt(flt_c),
    )).astype(np.float32)
    mine = got.float().numpy()
    assert (np.abs(mine - want) <= bf16_ulp(np.maximum(abs(mine),
                                                       abs(want)))).all()


def test_upsample_nnf_planes_equal_jax(rng):
    for (h, w), (ha, wa) in (((9, 11), (7, 12)), ((16, 16), (16, 16))):
        py = rng.integers(0, 8, ((h + 1) // 2, (w + 1) // 2))
        px = rng.integers(0, 8, ((h + 1) // 2, (w + 1) // 2))
        got = tan.upsample_nnf_planes(T(py), T(px), (h, w), ha, wa)
        want = jan.upsample_nnf_planes(jnp.asarray(py), jnp.asarray(px),
                                       (h, w), ha, wa)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        stacked = tan.upsample_nnf(torch.stack([T(py), T(px)], -1), (h, w),
                                   ha, wa)
        assert torch.equal(stacked, torch.stack(got, -1))


def test_random_init_planes_equal_random_init():
    gen = t_pm.init_generator(3, 2, "cpu")
    py, px = t_pm.random_init_planes(gen, 9, 13, 20, 30)
    stacked = t_pm.random_init(t_pm.init_generator(3, 2, "cpu"), 9, 13, 20, 30)
    assert torch.equal(torch.stack([py, px], -1), stacked)
    assert 0 <= int(py.min()) and int(py.max()) < 20 and int(px.max()) < 30


def _tables(rng, h, w, ha, wa, d, bf16=True):
    f_b = rng.standard_normal((h * w, d)).astype(np.float32)
    f_a = rng.standard_normal((ha * wa, d)).astype(np.float32)
    if bf16:
        f_b = f_b.astype(jnp.bfloat16).astype(np.float32)
        f_a = f_a.astype(jnp.bfloat16).astype(np.float32)
    return f_b, f_a


@pytest.mark.parametrize("factor", [1.0, 3.0])
def test_coherence_sweeps_lean(rng, factor):
    """Against JAX's on the same bf16 tables and field (fields equal,
    distances rtol 1e-5), and bit-identical to the port's stacked
    `coherence_sweeps`."""
    h = w = ha = wa = 24
    f_b, f_a = _tables(rng, h, w, ha, wa, 7)
    py = rng.integers(0, ha, (h, w))
    px = rng.integers(0, wa, (h, w))
    tb16, ta16 = T(f_b).to(torch.bfloat16), T(f_a).to(torch.bfloat16)

    def dist_fn(idx):
        return candidate_dist_lean(tb16, ta16, idx)

    dist = dist_fn(T(py * wa + px).reshape(-1)).reshape(h, w)
    got = t_coh.coherence_sweeps_lean(T(py), T(px), dist, ha=ha, wa=wa,
                                      factor=factor, sweeps=2,
                                      dist_fn=dist_fn)
    jb, ja = jnp.asarray(f_b, jnp.bfloat16), jnp.asarray(f_a, jnp.bfloat16)
    want = j_coh.coherence_sweeps_lean(
        jnp.asarray(py, jnp.int32), jnp.asarray(px, jnp.int32),
        jnp.asarray(dist.numpy()), ha=ha, wa=wa, factor=factor, sweeps=2,
        dist_fn=lambda i: j_match.candidate_dist_lean(jb, ja, i))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    nnf_s, dist_s = t_coh.coherence_sweeps(
        tb16.reshape(h, w, -1), ta16.reshape(ha, wa, -1),
        torch.stack([T(py), T(px)], -1), dist, factor=factor, sweeps=2)
    assert torch.equal(torch.stack(got[:2], -1), nnf_s)
    assert torch.equal(got[2], dist_s)
    if factor > 1.0:
        assert (got[0].numpy() != py).any()


def _jax_lean_offsets(key, iters, radii, h, w):
    """The draws JAX `patchmatch_sweeps_lean` makes, by its own key
    derivation: one key per sweep, one per radius, then (ky, kx)."""
    out = []
    for it_key in jax.random.split(key, iters):
        per = []
        for r, rk in zip(radii, jax.random.split(it_key, len(radii))):
            ky, kx = jax.random.split(rk)
            per.append(torch.stack([
                T(np.array(jax.random.randint(ky, (h, w), -r, r + 1))),
                T(np.array(jax.random.randint(kx, (h, w), -r, r + 1))),
            ], -1))
        out.append(torch.stack(per).long())
    return out


@pytest.mark.parametrize("coh", [1.0, 2.0])
def test_patchmatch_sweeps_lean_given_jax_draws(rng, coh):
    """JAX's lean draws in, the same field out except at ties, distances
    rtol 1e-5; and equal to the port's stacked `patchmatch_sweeps` on the
    same tables and draws."""
    h, w, ha, wa, d = 20, 22, 24, 26, 18
    f_b, f_a = _tables(rng, h, w, ha, wa, d)
    py = rng.integers(0, ha, (h, w))
    px = rng.integers(0, wa, (h, w))
    key = jax.random.PRNGKey(5)
    iters, n_random = 3, 4
    radii = t_pm.sweep_radii(ha, wa, n_random)
    jb, ja = jnp.asarray(f_b, jnp.bfloat16), jnp.asarray(f_a, jnp.bfloat16)
    jy, jx, jd = j_pm.patchmatch_sweeps_lean(
        jb, ja, jnp.asarray(py, jnp.int32), jnp.asarray(px, jnp.int32), key,
        ha=ha, wa=wa, iters=iters, n_random=n_random, coh_factor=coh)
    offsets = _jax_lean_offsets(key, iters, radii, h, w)
    tb16, ta16 = T(f_b).to(torch.bfloat16), T(f_a).to(torch.bfloat16)
    ty, tx, td = t_pm.patchmatch_sweeps_lean(
        tb16, ta16, T(py), T(px), offsets, ha=ha, wa=wa, coh_factor=coh)
    same = (ty.numpy() == np.asarray(jy)) & (tx.numpy() == np.asarray(jx))
    assert same.mean() > 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    nnf_s, d_s = t_pm.patchmatch_sweeps(
        tb16.reshape(h, w, d), ta16.reshape(ha, wa, d),
        torch.stack([T(py), T(px)], -1), offsets, coh_factor=coh)
    assert torch.equal(torch.stack([ty, tx], -1), nnf_s)
    assert torch.equal(td, d_s)


@pytest.mark.parametrize("size,levels,matcher,budget", [
    (2048, 6, "patchmatch", None),
    (3072, 6, "patchmatch", None),
    (4096, 6, "patchmatch", None),
    (1024, 5, "patchmatch", None),
    (4096, 6, "brute", None),
    (2048, 6, "brute", None),
    (256, 3, "patchmatch", 1),
])
def test_plan_level_matches_jax(size, levels, matcher, budget):
    """The lean decision and the incoming field's layout at the
    reference's scale sizes (`tools/scale_bench.py`) and a forced budget:
    2048^2 level 0 and 3072^2 / 4096^2 levels 0-1 are lean for
    PatchMatch, 4096^2 level 0 for brute."""
    kw = dict(levels=levels, matcher=matcher)
    if budget:
        kw["feature_bytes_budget"] = budget
    tcfg = SynthConfig(device="cpu", **kw)
    jcfg = JCfg(pallas_mode="interpret", **kw)
    lean_levels, prev = [], None
    for lvl in range(levels - 1, -1, -1):
        s = -(-size // 2**lvl)
        has_coarse = lvl < levels - 1
        meta = torch.empty((s, s), device="meta")
        zero = np.broadcast_to(np.float32(0), (s, s))
        got = tan.plan_level(tcfg, lvl, meta, meta, has_coarse, s, s,
                             prev_nnf=prev)
        want = jan.plan_level(jcfg, lvl, zero, zero, has_coarse, s, s,
                              prev_nnf=prev)
        assert (got.lean, got.prev_kind) == (want.lean, want.prev_kind)
        assert (got.tile is None) == (matcher == "brute" or s < 128)
        prev = (0, 0) if got.lean else None
        if got.lean:
            lean_levels.append(lvl)
    expect = {(2048, "patchmatch"): [0], (3072, "patchmatch"): [1, 0],
              (4096, "patchmatch"): [1, 0], (4096, "brute"): [0],
              (256, "patchmatch"): [1, 0]}
    assert lean_levels == expect.get((size, matcher), [])


def test_pca_warns_on_a_lean_level(caplog):
    meta = torch.empty((128, 128), device="meta")
    cfg = SynthConfig(device="cpu", pca_dims=8, feature_bytes_budget=1)
    with caplog.at_level(logging.WARNING, logger="image_analogies_tpu_torch"):
        plan = tan.plan_level(cfg, 0, meta, meta, False, 128, 128)
    assert plan.lean
    assert any("pca_dims=8 is not applied" in r.message
               for r in caplog.records)


@pytest.fixture(scope="module")
def pm128():
    """super_resolution(128), 2 levels, em 2: the port's brute oracle and
    the standard and forced-lean PatchMatch runs."""
    a, ap, b = super_resolution(128)
    kw = dict(levels=2, em_iters=2, pm_iters=3)
    oracle = port(a, ap, b, matcher="brute", levels=2, em_iters=2)
    normal = port(a, ap, b, **kw)
    return (a, ap, b), kw, oracle, normal


def test_lean_patchmatch_tracks_oracle(pm128):
    """The lean path's B' equals the standard path's bit for bit (the
    same staging on tables equal to the standard fields' bf16 casts);
    the reference's bars (tests/test_pallas_lean.py) hold too: > 25 dB
    from the oracle and >= the standard path - 3 dB.  The lean tables
    are assembled on both sides (A in the level, B in the step)."""
    ex, kw, oracle, normal = pm128
    calls = []
    real = tan.assemble_features_lean

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    with mock.patch.object(tan, "assemble_features_lean", counting):
        out = port(*ex, aux=True, feature_bytes_budget=1, **kw)
    assert len(calls) >= 2
    assert isinstance(out["nnf"][0], tuple) and out["nnf"][0][0].shape == (
        128, 128)
    # Level 1 (64^2) is below the tile rule: standard per-pixel path.
    assert not isinstance(out["nnf"][1], tuple)
    lean = out["bp"]
    assert torch.equal(lean, normal)
    p_lean, p_norm = psnr(lean, oracle), psnr(normal, oracle)
    assert p_lean > 25.0 and p_lean >= p_norm - 3.0, (p_lean, p_norm)


def test_lean_kappa_changes_the_field(pm128):
    ex, kw, _, _ = pm128
    k0 = port(*ex, aux=True, feature_bytes_budget=1, kappa=0.0, **kw)
    k5 = port(*ex, aux=True, feature_bytes_budget=1, kappa=5.0, **kw)
    assert not torch.equal(k0["nnf"][0][0], k5["nnf"][0][0])
    assert torch.isfinite(k5["bp"]).all()


@pytest.mark.parametrize("cand_dtype,prune", [("bf16", "off"),
                                              ("int8", "16:8")])
def test_lean_compressed_modes(pm128, monkeypatch, cand_dtype, prune):
    """int8 A planes and the PCA prune at a lean level: the stream polish
    (K3's plain version, counted) bit-identical to the sequential one,
    the jump polish finite, all above the oracle bar."""
    from image_analogies_tpu_torch.kernels import polish_stream as tps

    ex, kw, oracle, normal = pm128
    monkeypatch.setattr(tpt, "_CAND_DTYPE", cand_dtype)
    monkeypatch.setattr(tpt, "_CAND_PRUNE", prune)
    calls = []
    real = tps.gather_rows

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tps, "gather_rows", spy)
    outs = {}
    for mode in ("stream", "sequential", "jump"):
        monkeypatch.setattr(t_pm, "_POLISH_MODE", mode)
        outs[mode] = port(*ex, feature_bytes_budget=1, **kw)
        if mode == "stream":
            # One polished EM step at the one tile level (128^2).
            assert len(calls) == tps.polish_eval_rows(1, 2, 4)
    assert len(calls) == tps.polish_eval_rows(1, 2, 4)
    assert torch.equal(outs["stream"], outs["sequential"])
    for out in outs.values():
        assert torch.isfinite(out).all()
        assert psnr(out, oracle) > 25.0
    assert psnr(outs["sequential"], oracle) >= psnr(normal, oracle) - 3.0


@pytest.fixture(scope="module")
def brute48():
    """The lean-brute oracle at 48^2, 2 levels, in both packages, and the
    port's standard brute."""
    a, ap, b = super_resolution(48)
    kw = dict(levels=2, matcher="brute", em_iters=2)
    jax_lean = np.asarray(j_create(a, ap, b, JCfg(brute_lean_bytes=1, **kw)))
    std = port(a, ap, b, **kw)
    lean = port(a, ap, b, aux=True, brute_lean_bytes=1, **kw)
    return (a, ap, b), kw, jax_lean, std, lean


def test_lean_brute_against_jax_and_standard(brute48):
    """B' against the JAX lean-brute B': 142.6 dB on the CPU at 48^2, 2
    levels (the same picks; float rounding of the render and the chroma
    only), asserted >= 100 dB, which one differing pick would break; and
    >= 33 dB from the port's standard brute (42.3 dB;
    tests/test_synthesis.py's gate)."""
    _, _, jax_lean, std, lean = brute48
    assert isinstance(lean["nnf"][0], tuple)
    assert isinstance(lean["nnf"][1], tuple)
    vs_jax = psnr(lean["bp"].numpy(), jax_lean)
    assert vs_jax >= 100.0, vs_jax
    assert psnr(lean["bp"], std) >= 33.0


def test_lean_brute_field_is_exact_argmin_of_its_tables():
    """em_iters=1: rebuilding level 0's lean tables from the level-1
    estimate and searching them exactly reproduces the stored field."""
    from image_analogies_tpu_torch.models.brute import exact_nn
    from image_analogies_tpu_torch.ops.pyramid import upsample

    a, ap, b = super_resolution(48)
    cfg = SynthConfig(device="cpu", levels=2, matcher="brute", em_iters=1,
                      brute_lean_bytes=1)
    r = create_image_analogy(a, ap, b, cfg, return_aux=True)
    py0, px0 = r["nnf"][0]
    t = (lambda x: torch.as_tensor(x))
    pyr = tan.prologue(t(a), t(ap), t(b)[None], cfg, 2)
    src_a, flt_a, _, copy_a = pyr[:4]
    src_b = [x[0] for x in pyr[2]]
    flt1 = tan._gather_planes(copy_a[1], *r["nnf"][1])
    h, w = src_b[0].shape[:2]
    f_b = tan.assemble_features_lean(src_b[0], upsample(flt1, (h, w)), cfg,
                                     src_b[1], flt1)
    f_a = tan.assemble_features_lean(src_a[0], flt_a[0], cfg, src_a[1],
                                     flt_a[1])
    idx, _ = exact_nn(f_b, f_a, chunk=min(cfg.brute_chunk, h * w),
                      match_dtype=torch.bfloat16)
    wa = src_a[0].shape[1]
    assert torch.equal(idx.reshape(h, w), py0 * wa + px0)


@pytest.mark.parametrize("kappa", [0.0, 5.0])
def test_lean_brute_b_bands_bit_identical(monkeypatch, kappa):
    """B-side row bands under a tiny band budget reproduce the unbanded
    search bit for bit, kappa = 0 and > 0."""
    a, ap, b = super_resolution(64)
    kw = dict(levels=2, matcher="brute", em_iters=2, brute_lean_bytes=1,
              kappa=kappa)
    whole = port(a, ap, b, **kw)
    searched = []
    real = tan.assemble_features_lean

    def spy(src, *args, **kwargs):
        searched.append(src.shape[0])
        return real(src, *args, **kwargs)

    monkeypatch.setattr(tan, "_B_BAND_TABLE_BYTES", 64 * 64 * 256 // 4)
    monkeypatch.setattr(tan, "assemble_features_lean", spy)
    banded = port(a, ap, b, **kw)
    assert min(searched) <= 12  # B was assembled in bands of 8 + halo
    assert torch.equal(banded, whole)


def test_lean_brute_kappa_acts(brute48):
    ex, kw, _, _, lean = brute48
    k5 = port(*ex, brute_lean_bytes=1, kappa=5.0, **kw)
    assert not torch.equal(k5, lean["bp"])
    assert psnr(k5, port(*ex, kappa=5.0, **kw)) >= 33.0

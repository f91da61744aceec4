"""The port's CUDA kernels against their plain PyTorch versions on the
card, over shapes and channel sets the main path's smoke check does not
cover: ragged tiles, A and B of different sizes, rgb and steerable
channel sets, a wider window, kappa > 1, tied and tiny tables; K1's
int8 mode and both its instantiations (compile-time and run-time
windows), its frame axis against single-frame launches (bit for bit) and
the batch runner's frames against their solo runs; K2's float32 (three
TF32 passes) and bfloat16 rows at widths 8 to 256; K3's row gather
in three dtypes; and K5's candidate tables against the plain builder
bit for bit at the benchmark's geometries, in a super-resolution run
(the same B' as the plain tables, one launch per K1 launch) and with
no host sync or copy in the sweep phase.

Needs an NVIDIA GPU, nvcc and no JAX; skipped elsewhere.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.kernels import cand_tables as ct
from image_analogies_tpu_torch.kernels import nn_brute as nb
from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
from image_analogies_tpu_torch.kernels import polish_stream as ps
from image_analogies_tpu_torch.models.matcher import candidate_dist

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev):
    return torch.as_tensor(rng.random(shape, dtype=np.float32), device=dev)


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("h,w,ha,wa,n_src,n_flt,coarse,coh,kw", [
    (300, 500, 260, 380, 1, 1, True, 1.0, {}),
    (128, 128, 128, 128, 1, 1, False, 2.0, {}),
    (200, 260, 200, 260, 3, 3, True, 1.5, {"color_mode": "rgb"}),
    (200, 260, 200, 260, 3, 3, False, 1.5, {"color_mode": "rgb"}),
    (256, 130, 192, 300, 5, 1, True, 1.0, {"steerable": True}),
    (192, 192, 256, 256, 1, 1, True, 1.2,
     {"patch_size": 7, "coarse_patch_size": 5}),
])
def test_tile_sweep_kernel_matches_plain(dev, h, w, ha, wa, n_src, n_flt,
                                         coarse, coh, kw, general):
    rng = np.random.default_rng(h * 7 + w)
    specs = pt.channel_specs(n_src, n_flt, SynthConfig(**kw), coarse)
    assert pt.kernel_fits(specs)
    geom = pt.tile_geometry(h, w, specs)

    def img(hh, ww, c):
        return _rand(rng, (hh, ww, c) if c > 1 else (hh, ww), dev)

    hc, wc, hac, wac = (h + 1) // 2, (w + 1) // 2, (ha + 1) // 2, (wa + 1) // 2
    a_planes = pt.prepare_a_planes(
        img(ha, wa, n_src), img(ha, wa, n_flt),
        img(hac, wac, n_src) if coarse else None,
        img(hac, wac, n_flt) if coarse else None, specs)
    b_planes = pt.prepare_b_planes(
        img(h, w, n_src), img(h, w, n_flt),
        img(hc, wc, n_src) if coarse else None,
        img(hc, wc, n_flt) if coarse else None, geom)
    qy = torch.arange(h, device=dev)[:, None]
    qx = torch.arange(w, device=dev)[None, :]
    oy = pt.to_compact(
        (torch.randint(0, ha, (h, w), device=dev) - qy).int(), geom)
    ox = pt.to_compact(
        (torch.randint(0, wa, (h, w), device=dev) - qx).int(), geom)
    d_in = torch.where(
        torch.rand(oy.shape, device=dev) < 0.5,
        torch.full(oy.shape, float("inf"), device=dev),
        torch.rand(oy.shape, device=dev) * float(len(specs)) * 0.3,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cy, cx, cv = pt.sample_candidates_blocked(
        oy, ox, pt.draw_candidates(gen, geom, ha, wa), geom, ha, wa)
    cv = (cv * (torch.rand(cv.shape, device=dev) > 0.3)).int().contiguous()
    args = (a_planes, b_planes, cy, cx, cv, oy, ox, d_in)
    kw2 = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh)
    before = pt.launches.count
    if general:  # the run-time tap loops, whatever the windows
        got = pt.tile_sweep_kernel(*args, general=True, **kw2)
    else:
        got = pt.tile_sweep(*args, **kw2)
    assert pt.launches.count == before + 1
    want = pt.tile_sweep_plain(*args, **kw2)
    torch.cuda.synchronize()
    kd, pd = got[2][:h, :w], want[2][:h, :w]
    tol = 1e-5 + 1e-4 * pd.abs()
    same_inf = torch.isinf(kd) & torch.isinf(pd)
    assert bool(((kd - pd).abs() <= tol).logical_or(same_inf).all())
    differ = (got[0][:h, :w] != want[0][:h, :w]) | (
        got[1][:h, :w] != want[1][:h, :w])
    assert float(differ.float().mean()) < 0.01
    bad = pt.unexplained_offsets(got, want, (oy, ox, d_in), a_planes,
                                 b_planes, specs=specs, geom=geom, ha=ha,
                                 wa=wa, h=h, w=w)
    assert not bool(bad.any())


@pytest.mark.parametrize("n_b,n_a,d", [(1000, 3000, 68), (777, 65, 204),
                                       (5, 3, 17), (4096, 4100, 50),
                                       (129, 257, 8), (1001, 2999, 150),
                                       (300, 1025, 256)])
def test_nn_argmin_kernel_matches_plain(dev, n_b, n_a, d):
    """float32 rows: the kernel's three TF32 passes against the plain
    version's emulation of them and against the float32 argmin, equal
    except at ties in the exact distance."""
    rng = np.random.default_rng(n_b + n_a + d)
    f_b = _rand(rng, (n_b, d), dev)
    f_a = _rand(rng, (n_a, d), dev)
    a_sq = nb.squared_norms(f_a)
    idx_k = nb.nn_argmin_kernel(f_b, f_a, a_sq)
    d_k = candidate_dist(f_b, f_a, idx_k)
    for passes in (3, 0):
        idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq, tf32_passes=passes)
        d_p = candidate_dist(f_b, f_a, idx_p)
        differ = idx_k != idx_p
        assert not bool(
            (differ & ((d_k - d_p).abs() > 1e-5 * d_p.abs())).any())
        assert float(differ.float().mean()) < 0.01


def test_nn_argmin_kernel_first_index_ties(dev):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    base[550] = base[3]
    base[130] = base[100]
    f_a = torch.as_tensor(base, device=dev)
    f_b = f_a[[3, 550, 100, 130]].contiguous()
    idx = nb.nn_argmin_kernel(f_b, f_a, nb.squared_norms(f_a))
    assert idx.tolist() == [3, 3, 100, 100]
    # Constant tables: every row ties, within and across tiles and
    # blocks, so every query takes row 0.
    for dtype in (torch.float32, torch.bfloat16):
        const = torch.ones(300, 8, device=dev, dtype=dtype)
        idx = nb.nn_argmin_kernel(const[:70].contiguous(), const,
                                  nb.squared_norms(const))
        assert idx.tolist() == [0] * 70
        wide = torch.full((1500, 150), 0.5, device=dev, dtype=dtype)
        idx = nb.nn_argmin_kernel(wide[:700].contiguous(), wide,
                                  nb.squared_norms(wide))
        assert idx.tolist() == [0] * 700


def test_kernel_wrappers_reject_bad_input(dev):
    f = torch.rand(10, 8, device=dev)
    with pytest.raises(ValueError):
        nb.nn_argmin_kernel(f.double(), f, nb.squared_norms(f))
    with pytest.raises(ValueError):
        nb.nn_argmin_kernel(f.t(), f.t(), nb.squared_norms(f.t()))
    with pytest.raises(ValueError):
        nb.nn_argmin_kernel(f.bfloat16(), f, nb.squared_norms(f))
    wide = torch.rand(10, 300, device=dev)
    with pytest.raises(ValueError, match="past the kernel"):
        nb.nn_argmin_kernel(wide, wide, nb.squared_norms(wide))
    with pytest.raises(ValueError, match="LANE-padded"):
        ps.gather_rows(f, torch.zeros(3, dtype=torch.long, device=dev))
    before = nb.launches.count
    assert nb.nn_argmin(f, f, match_dtype=torch.bfloat16).shape == (10,)
    assert nb.launches.count == before + 1


@pytest.mark.parametrize("n_b,n_a,d", [(1000, 3000, 68), (777, 65, 204),
                                       (4096, 4100, 50), (129, 257, 8),
                                       (1001, 2999, 150), (300, 1025, 256)])
def test_nn_argmin_kernel_bf16_matches_plain(dev, n_b, n_a, d):
    """bfloat16 rows: the kernel and the plain version pick the same rows
    except where the two picks tie in the metric both minimize."""
    rng = np.random.default_rng(n_b + n_a + d + 1)
    f_b = _rand(rng, (n_b, d), dev)
    f_a = _rand(rng, (n_a, d), dev)
    a_sq = nb.squared_norms(f_a)
    bf = torch.bfloat16
    idx_k = nb.nn_argmin_kernel(f_b.to(bf), f_a.to(bf), a_sq)
    idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq, match_dtype=bf)
    m_k = nb.argmin_metric(f_b, f_a, a_sq, idx_k, bf)
    m_p = nb.argmin_metric(f_b, f_a, a_sq, idx_p, bf)
    differ = idx_k != idx_p
    assert not bool((differ & ((m_k - m_p).abs() > 1e-5 * m_p.abs())).any())
    assert float(differ.float().mean()) < 0.01


def _sweep_case(dev, rng, h, w, ha, wa, coarse, n_chan=1, **cfg):
    """An int8 sweep case with `n_chan` source and filtered channels."""
    specs = pt.channel_specs(n_chan, n_chan, SynthConfig(**cfg), coarse)
    geom = pt.tile_geometry(h, w, specs)
    hc, wc, hac, wac = (h + 1) // 2, (w + 1) // 2, (ha + 1) // 2, (wa + 1) // 2

    def img(hh, ww):
        return _rand(rng, (hh, ww, n_chan) if n_chan > 1 else (hh, ww), dev)

    src = [img(ha, wa), img(ha, wa), img(hac, wac), img(hac, wac)]
    a8 = pt.prepare_a_planes(src[0], src[1], src[2] if coarse else None,
                             src[3] if coarse else None, specs,
                             cand_dtype="int8")
    b_planes = pt.prepare_b_planes(
        img(h, w), img(h, w), img(hc, wc) if coarse else None,
        img(hc, wc) if coarse else None, geom)
    qy = torch.arange(h, device=dev)[:, None]
    qx = torch.arange(w, device=dev)[None, :]
    oy = pt.to_compact(
        (torch.randint(0, ha, (h, w), device=dev) - qy).int(), geom)
    ox = pt.to_compact(
        (torch.randint(0, wa, (h, w), device=dev) - qx).int(), geom)
    d_in = torch.where(
        torch.rand(oy.shape, device=dev) < 0.5,
        torch.full(oy.shape, float("inf"), device=dev),
        torch.rand(oy.shape, device=dev) * float(len(specs)) * 0.3,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    cy, cx, cv = pt.sample_candidates_blocked(
        oy, ox, pt.draw_candidates(gen, geom, ha, wa), geom, ha, wa)
    cv = (cv * (torch.rand(cv.shape, device=dev) > 0.3)).int().contiguous()
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.4)
    return a8, b_planes, (cy, cx, cv, oy, ox, d_in), kw


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("h,w,ha,wa,coarse,rgb", [
    (300, 500, 260, 380, True, False), (128, 128, 128, 128, False, False),
    (200, 260, 200, 260, True, True), (200, 260, 200, 260, False, True),
])
def test_tile_sweep_kernel_int8_matches_plain_and_f32(dev, h, w, ha, wa,
                                                      coarse, rgb, general):
    rng = np.random.default_rng(h + wa)
    extra = dict(n_chan=3, color_mode="rgb") if rgb else {}
    a8, b_planes, rest, kw = _sweep_case(dev, rng, h, w, ha, wa, coarse,
                                         **extra)
    before = (pt.launches.count, pt.launches_int8.count)
    if general:
        got = pt.tile_sweep_kernel(a8, b_planes, *rest, general=True, **kw)
    else:
        got = pt.tile_sweep(a8, b_planes, *rest, cand_dtype="int8", **kw)
    assert (pt.launches.count, pt.launches_int8.count) == \
        (before[0], before[1] + 1)
    want = pt.tile_sweep_plain(a8, b_planes, *rest, **kw)
    deq = pt.tile_sweep_kernel(pt.dequantize_planes(a8), b_planes, *rest,
                               general=general, **kw)
    torch.cuda.synchronize()
    kd, pd = got[2][:h, :w], want[2][:h, :w]
    tol = 1e-5 + 1e-4 * pd.abs()
    same_inf = torch.isinf(kd) & torch.isinf(pd)
    assert bool(((kd - pd).abs() <= tol).logical_or(same_inf).all())
    geo = {k: v for k, v in kw.items() if k != "coh_factor"}
    bad = pt.unexplained_offsets(got, want, rest[3:], a8, b_planes, h=h,
                                 w=w, **geo)
    assert not bool(bad.any())
    assert torch.equal(got[0], deq[0]) and torch.equal(got[1], deq[1])
    fin = torch.isfinite(got[2])
    assert torch.equal(fin, torch.isfinite(deq[2]))
    assert bool(((got[2][fin] - deq[2][fin]).abs()
                 <= 1e-5 * deq[2][fin].abs()).all())


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,w,ha,wa,coarse,rgb", [
    (300, 500, 260, 380, True, False), (200, 260, 200, 260, True, True),
])
def test_tile_sweep_kernel_frame_axis_equals_single_frames(
        dev, h, w, ha, wa, coarse, rgb, int8, general):
    """Three frames in one launch (the grid's z dimension) against three
    single-frame launches on the same inputs: every output bit-equal,
    and one launch counted."""
    rng = np.random.default_rng(h + w + int(int8))
    extra = dict(n_chan=3, color_mode="rgb") if rgb else {}
    cases = [_sweep_case(dev, rng, h, w, ha, wa, coarse, **extra)
             for _ in range(3)]
    a8, _, _, kw = cases[0]
    a_planes = a8 if int8 else pt.dequantize_planes(a8)
    b_planes = torch.stack([c[1] for c in cases])
    rest = [torch.stack([c[2][k] for c in cases]) for k in range(6)]
    counter = pt.launches_int8 if int8 else pt.launches
    before = counter.count
    got = pt.tile_sweep_kernel(a_planes, b_planes, *rest, general=general,
                               **kw)
    assert counter.count == before + 1
    for i, (_, b_i, rest_i, _) in enumerate(cases):
        one = pt.tile_sweep_kernel(a_planes, b_i, *rest_i, general=general,
                                   **kw)
        torch.cuda.synchronize()
        for g, o in zip(got, one):
            assert torch.equal(g[i], o), i
    want = pt.tile_sweep_plain(a_planes, b_planes, *rest, **kw)
    torch.cuda.synchronize()
    geo = {k: v for k, v in kw.items() if k != "coh_factor"}
    for i in range(3):
        bad = pt.unexplained_offsets(
            [t[i] for t in got], [t[i] for t in want],
            [t[i] for t in rest[3:]], a_planes, b_planes[i], h=h, w=w, **geo)
        assert not bool(bad.any()), i


def test_batch_on_the_card_frames_equal_solo_runs(dev):
    """`synthesize_batch` at 256^2, three frames, both levels on the tile
    path: with frame_indices=[0] * 3 each frame equals its solo run (one
    frame-axis K1 launch a sweep against one a frame), and the kernel's
    result stays within the oracle bar of its plain version's."""
    from image_analogies_tpu_torch import psnr, synthesize_batch
    from image_analogies_tpu_torch.parallel.batch import stack_stats
    from image_analogies_tpu_torch.utils.examples import super_resolution

    a, ap, b = super_resolution(256)
    b = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    frames = torch.stack([b, b.flip(0), b.flip(1)])
    cfg = SynthConfig(levels=2, em_iters=2, pm_iters=3)
    before = pt.launches.count
    batched = synthesize_batch(a, ap, frames, cfg, frame_indices=[0] * 3)
    # Both levels (256^2, 128^2) take the tile path.
    assert pt.launches.count == before + 2 * 2 * 3
    stats = stack_stats(frames, cfg)
    for i in range(3):
        solo = synthesize_batch(a, ap, frames[i:i + 1], cfg, _b_stats=stats)
        assert torch.equal(batched[i], solo[0]), i
    plain = synthesize_batch(a, ap, frames, SynthConfig(
        levels=2, em_iters=2, pm_iters=3, pallas_mode="interpret"),
        frame_indices=[0] * 3)
    for i in range(3):
        assert psnr(batched[i], plain[i]) > 30.0, i


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("keep", [0.7, 0.1, 0.0])
def test_tile_sweep_kernel_keeps_slot_order_on_ties(dev, keep, int8, general):
    """Flat A planes: every candidate of a pixel scores the same bits, so
    the strict `<` keeps the first valid slot of each range.  The
    kernel's compacted slot list must leave the offsets the plain
    version leaves, on every pixel."""
    rng = np.random.default_rng(int(keep * 10))
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    h, w, ha, wa = 128, 248, 200, 300
    geom = pt.tile_geometry(h, w, specs)
    p = geom.halo
    a_shape = (len(specs), ha + 2 * p, wa + 2 * p)
    a_planes = (torch.zeros(a_shape, dtype=torch.int8, device=dev) if int8
                else torch.full(a_shape, 0.5, device=dev))
    b_planes = _rand(rng, (len(specs), geom.n_ty * geom.tile_h + 2 * p,
                           geom.n_tx * geom.tile_w + 2 * p), dev)
    shape = (geom.n_ty, geom.n_tx, pt.K_TOTAL)
    cy = torch.as_tensor(rng.integers(-300, 300, shape), dtype=torch.int32,
                         device=dev)
    cx = torch.as_tensor(rng.integers(-400, 400, shape), dtype=torch.int32,
                         device=dev)
    cv = torch.as_tensor(rng.random(shape) < keep, device=dev).int()
    state = (geom.n_ty * geom.tile_h, geom.n_tx * geom.tile_w)
    oy = torch.full(state, -7, dtype=torch.int32, device=dev)
    ox = torch.full(state, 9, dtype=torch.int32, device=dev)
    d_in = torch.full(state, float("inf"), device=dev)
    args = (a_planes, b_planes, cy, cx, cv, oy, ox, d_in)
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    got = pt.tile_sweep_kernel(*args, general=general, **kw)
    want = pt.tile_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0][:h, :w], want[0][:h, :w])
    assert torch.equal(got[1][:h, :w], want[1][:h, :w])


def test_tile_sweep_rejects_planes_of_the_other_mode(dev):
    rng = np.random.default_rng(3)
    a8, b_planes, rest, kw = _sweep_case(dev, rng, 128, 128, 128, 128, False)
    with pytest.raises(ValueError, match="cand_dtype"):
        pt.tile_sweep(a8, b_planes, *rest, cand_dtype="bf16", **kw)
    with pytest.raises(ValueError, match="cand_dtype"):
        pt.tile_sweep(pt.dequantize_planes(a8), b_planes, *rest,
                      cand_dtype="int8", **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
@pytest.mark.parametrize("na,idx_shape", [(300, (1000,)), (97, (3, 41)),
                                          (5, (1,)), (70000, (65537,))])
def test_gather_rows_kernel_matches_plain(dev, dtype, na, idx_shape):
    rng = np.random.default_rng(na)
    if dtype == torch.int8:
        tab = torch.randint(-127, 128, (na, 68), dtype=torch.int8,
                            device=dev)
    else:
        tab = _rand(rng, (na, 68), dev).to(dtype)
    table = ps.prepare_polish_table(tab)
    idx = torch.as_tensor(rng.integers(-5, na + 5, idx_shape), device=dev)
    before = ps.launches.count
    got = ps.gather_rows(table, idx)
    assert ps.launches.count == before + 1
    want = ps.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (idx.numel(), ps.LANE)
    assert torch.equal(got, want)
    assert torch.equal(ps.gather_rows(table, idx, plain=True), want)
    assert ps.launches.count == before + 1


def test_lean_patchmatch_kernels_against_interpret(dev):
    """Lean PatchMatch at 256^2 (feature_bytes_budget=1, one level) with
    the kernels and with their plain versions (pallas_mode="interpret")
    on the card: the first sweep's offsets equal except at ties, the
    kernel counted once per sweep, both B' above the oracle bar."""
    from image_analogies_tpu_torch import create_image_analogy, psnr
    from image_analogies_tpu_torch.utils.examples import super_resolution

    a, ap, b = super_resolution(256)
    kw = dict(levels=1, em_iters=2, pm_iters=3, feature_bytes_budget=1)
    oracle = create_image_analogy(a, ap, b, SynthConfig(
        levels=1, em_iters=2, matcher="brute"))
    first = []
    real = pt.tile_sweep

    def spy(*args, **kwargs):
        if not first:
            first.append((tuple(t.clone() for t in args), dict(kwargs)))
        return real(*args, **kwargs)

    before = pt.launches.count
    pt.tile_sweep = spy
    try:
        auto = create_image_analogy(a, ap, b, SynthConfig(**kw))
    finally:
        pt.tile_sweep = real
    assert pt.launches.count == before + 2 * 3
    before = pt.launches.count
    plain = create_image_analogy(a, ap, b, SynthConfig(
        pallas_mode="interpret", **kw))
    assert pt.launches.count == before
    args, kwargs = first[0]
    # The tile path passes one image with a frame axis of 1.
    args = args[:1] + tuple(t[0] for t in args[1:])
    geo = {k: kwargs[k] for k in ("specs", "geom", "ha", "wa")}
    got = pt.tile_sweep_kernel(*args, coh_factor=kwargs["coh_factor"], **geo)
    want = pt.tile_sweep_plain(*args, coh_factor=kwargs["coh_factor"], **geo)
    bad = pt.unexplained_offsets(got, want, args[5:8], args[0], args[1],
                                 h=256, w=256, **geo)
    assert not bool(bad.any())
    for out in (auto, plain):
        assert psnr(out, oracle) > 25.0


def test_lean_brute_k2_bf16_against_plain(dev):
    """The lean-brute oracle at 64^2 (brute_lean_bytes=1, 2 levels): K2
    launched on bf16 rows once per level and EM step, and its level-0
    picks equal to the plain version's except at ties in the metric both
    minimize."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.models import brute
    from image_analogies_tpu_torch.utils.examples import super_resolution

    a, ap, b = super_resolution(64)
    calls = []
    real = brute.nn_argmin

    def spy(f_b, f_a, *args, **kwargs):
        idx = real(f_b, f_a, *args, **kwargs)
        calls.append((f_b, f_a, idx))
        return idx

    before = nb.launches.count
    brute.nn_argmin = spy
    try:
        out = create_image_analogy(a, ap, b, SynthConfig(
            levels=2, em_iters=2, matcher="brute", brute_lean_bytes=1))
    finally:
        brute.nn_argmin = real
    assert nb.launches.count == before + 4
    assert torch.isfinite(out).all()
    bf = torch.bfloat16
    for f_b, f_a, idx_k in calls:
        assert f_b.dtype == f_a.dtype == bf
        a_sq = nb.squared_norms(f_a)
        idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq, match_dtype=bf)
        m_k = nb.argmin_metric(f_b, f_a, a_sq, idx_k, bf)
        m_p = nb.argmin_metric(f_b, f_a, a_sq, idx_p, bf)
        differ = idx_k != idx_p
        assert not bool(
            (differ & ((m_k - m_p).abs() > 1e-5 * m_p.abs())).any())


def test_traced_run_books_each_launch_in_the_registry(dev):
    """On the card each K1 and K2 launch books
    `ia_kernel_launches_total{kernel}` beside its module counter, and a
    traced run's B' is the untraced run's."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.telemetry import MetricsRegistry, Tracer
    from image_analogies_tpu_torch.telemetry.metrics import set_registry

    rng = np.random.default_rng(11)
    a = rng.random((256, 256)).astype(np.float32)
    for matcher, counter, name in (("patchmatch", pt.launches, "tile_sweep"),
                                   ("brute", nb.launches, "exact_nn")):
        cfg = SynthConfig(levels=2, em_iters=2, matcher=matcher)
        plain = create_image_analogy(a, a * 0.5, a[::-1].copy(), cfg)
        reg = MetricsRegistry()
        prev = set_registry(reg)
        counter.reset()
        try:
            traced = create_image_analogy(a, a * 0.5, a[::-1].copy(), cfg,
                                          progress=Tracer(registry=reg))
        finally:
            set_registry(prev)
        assert counter.count > 0
        assert reg.counter("ia_kernel_launches_total").value(
            labels={"kernel": name}) == counter.count
        assert torch.equal(traced, plain)


def test_ann_matcher_on_the_card_equals_the_cpu(dev):
    """The ann matcher copies CUDA features to the host tree and its
    field back to the card: the same field and distances as on the CPU."""
    from image_analogies_tpu_torch.models import get_matcher
    from image_analogies_tpu_torch.utils.native import ann_available

    if not ann_available():
        pytest.skip("native ANN library not buildable")
    rng = np.random.default_rng(5)
    f_a = rng.standard_normal((40, 40, 12)).astype(np.float32)
    f_b = rng.standard_normal((30, 50, 12)).astype(np.float32)
    m = get_matcher("ann")
    outs = {}
    for d in ("cpu", "cuda"):
        nnf, dist = m.match(
            torch.as_tensor(f_b, device=d), torch.as_tensor(f_a, device=d),
            torch.zeros(30, 50, 2, dtype=torch.long, device=d), level=0,
            cfg=SynthConfig(matcher="ann", ann_eps=0.0, device=d))
        assert nnf.device.type == d
        outs[d] = (nnf.cpu(), dist.cpu())
    assert torch.equal(outs["cpu"][0], outs["cuda"][0])
    assert torch.equal(outs["cpu"][1], outs["cuda"][1])


def test_k1_ledger_books_the_launch_bound_on_the_card(dev):
    """Each K1 launch books fetches x window bytes as one unit, at its
    static bound (every slot, or the prune's M), and the sentinel prices
    it exactly."""
    from image_analogies_tpu_torch.telemetry import metrics as tm
    from image_analogies_tpu_torch.telemetry.sentinel import (
        check_candidate_dma,
    )
    from image_analogies_tpu_torch.utils.kernelbench import sweep_setup

    reg = tm.MetricsRegistry()
    prev = tm.set_registry(reg)
    try:
        one_iter, s0, meta = sweep_setup(SynthConfig(), 256)
        one_iter(*s0)
        torch.cuda.synchronize()
    finally:
        tm.set_registry(prev)
    geom = meta["geom"]
    want = geom.n_ty * geom.n_tx * pt.K_TOTAL * (64 // meta["strip_rows"])
    m = reg.to_dict()
    assert sum(m["ia_candidate_dma_fetches_total"]["values"].values()) \
        == want
    res = check_candidate_dma(m)
    assert res["status"] == "ok" and res["expected"] == res["observed"]


def test_kernelbench_instruments_agree_on_the_card(dev, tmp_path):
    from image_analogies_tpu_torch.telemetry.sentinel import (
        check_instrument_drift,
    )
    from image_analogies_tpu_torch.utils import kernelbench

    cfg = SynthConfig()
    events, meta = kernelbench.sweep_time_ms(cfg, 256, iters=8)
    loop, _ = kernelbench.sweep_time_device_loop_ms(cfg, 256, iters=8,
                                                    reps=3)
    trace = kernelbench.sweep_time_trace_ms(cfg, 256, iters=8,
                                            trace_dir=str(tmp_path))
    assert trace is not None and events > 0 and loop > 0
    assert check_instrument_drift({"kernel_sweep_ms_loop": loop,
                                   "kernel_sweep_ms_trace": trace[0]})[
        "status"] == "ok"


def test_profiled_k1_launches_sit_under_their_ranges(dev, tmp_path):
    """A profiled tile-path run: every K1 kernel in the trace is
    attributed to a tlm_L*/tlm_em*/tlm_match path by its launch."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.telemetry import Tracer
    from image_analogies_tpu_torch.utils import torch_trace as tt
    from image_analogies_tpu_torch.utils.examples import super_resolution
    from image_analogies_tpu_torch.utils.profiling import device_trace

    a, ap, b = (torch.as_tensor(x) for x in super_resolution(256))
    cfg = SynthConfig(levels=2, em_iters=1, pm_iters=2)
    create_image_analogy(a, ap, b, cfg)
    with device_trace(str(tmp_path), cuda=True):
        create_image_analogy(a, ap, b, cfg, progress=Tracer())
        torch.cuda.synchronize()
    scoped = tt.summarize(tt.load_events(tt.find_trace(str(tmp_path))))[
        "scoped_ops"]
    k1 = [k for k in scoped if "tile_sweep_kernel" in k]
    assert k1 and all(k.startswith("tlm_L") and "/tlm_match/" in k
                      for k in k1)


def test_traced_run_times_every_span_on_the_device(dev, monkeypatch):
    """A traced 256² run (tile path at 256² and 128², per-pixel sweeps at
    64²): every live span resolves a device interval, children lie inside
    their parents and siblings in order, within 20 us; the EM steps sum
    to no more than their level; the trace adds at most one device sync
    (the anchor) to the untraced run's and the level records' own; B' is
    the untraced run's."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.telemetry import Tracer
    from image_analogies_tpu_torch.utils.examples import super_resolution

    a, ap, b = (torch.as_tensor(x, device="cuda")
                for x in super_resolution(256))
    cfg = SynthConfig(levels=3, em_iters=2, kappa=0.5)
    create_image_analogy(a, ap, b, cfg)  # builds and warms
    real, syncs = torch.cuda.synchronize, []

    def counted(*args, **kw):
        syncs.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    plain = create_image_analogy(a, ap, b, cfg)
    n_plain, syncs[:] = len(syncs), []
    tracer = Tracer()
    traced = create_image_analogy(a, ap, b, cfg, progress=tracer)
    n_traced = len(syncs)
    monkeypatch.undo()
    # The prologue record, one a level, and the anchor.
    assert n_traced <= n_plain + 1 + 3 + 1
    assert torch.equal(traced, plain)
    slack = 20e-6

    def walk(sp):
        timed = [c for c in sp.children
                 if c.timed and c.name != "prologue"]
        for c in timed:
            assert c.device_ms is not None, c.name
            assert c.dev_t0 >= sp.dev_t0 - slack, (sp.name, c.name)
            assert c.dev_t1 <= sp.dev_t1 + slack, (sp.name, c.name)
        for x, y in zip(timed, timed[1:]):
            assert x.dev_t1 <= y.dev_t0 + slack, (x.name, y.name)
        for c in timed:
            walk(c)

    (run,) = tracer.roots
    assert run.device_ms is not None
    walk(run)
    for lvl in tracer.find("level"):
        em_ms = sum(e.device_ms for e in lvl.children)
        assert em_ms <= lvl.device_ms + 0.1
    assert tracer.find("sweep") and tracer.find("pixel") and tracer.find(
        "polish")
    assert all(sp.device_ms > 0 for sp in tracer.find("polish"))


# ------------------------------------------------------------------ K5

SUPERRES = json.loads(
    (Path(__file__).resolve().parents[1] / "portbench" / "configs"
     / "superres.json").read_text())["synth"]


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("n_f", [1, 4])
@pytest.mark.parametrize("n_src", [1, 5])
@pytest.mark.parametrize("h,w,ha,wa", [
    (1024, 1024, 1024, 1024), (512, 512, 512, 512), (256, 256, 256, 256),
    (128, 128, 128, 128), (300, 500, 260, 380),
])
def test_cand_tables_kernel_equals_plain(dev, h, w, ha, wa, n_src, n_f,
                                         coarse):
    """K5 against the plain builder bit for bit, on the benchmark's
    geometries (4 channels at halo 2; the steerable 12), one frame and
    four, uniform and coarse restarts; the frames' stacked draws are the
    ones each frame's generator gives alone."""
    specs = pt.channel_specs(n_src, 1, SynthConfig(steerable=n_src == 5),
                             True)
    geom = pt.tile_geometry(h, w, specs)

    def gens():
        out = []
        for i in range(n_f):
            g = torch.Generator(device=dev)
            g.manual_seed(h * 31 + w + 7 * i)
            out.append(g)
        return out

    draws = ct.draw_frames(gens(), geom, ha, wa, coarse)
    for i, g in enumerate(gens()):
        one = pt.draw_candidates(g, geom, ha, wa, coarse)
        for x, y in zip(ct.frame_draws(draws, i), one):
            assert (x is None and y is None) or torch.equal(x, y)
    g = torch.Generator(device=dev)
    g.manual_seed(n_f + 3)
    qy = torch.arange(h, device=dev)[:, None]
    qx = torch.arange(w, device=dev)[None, :]
    oy = torch.stack([pt.to_compact(
        (torch.randint(0, ha, (h, w), generator=g, device=dev) - qy).int(),
        geom) for _ in range(n_f)])
    ox = torch.stack([pt.to_compact(
        (torch.randint(0, wa, (h, w), generator=g, device=dev) - qx).int(),
        geom) for _ in range(n_f)])
    before = ct.launches.count
    got = ct.candidate_tables(oy, ox, draws, geom, ha, wa)
    assert ct.launches.count == before + 1
    want = ct.candidate_tables_plain(oy, ox, draws, geom, ha, wa)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == torch.int32 and torch.equal(x, y)
    assert 0 < int(want[2].sum()) < want[2].numel()


def test_cand_tables_kernel_rejects_bad_input(dev):
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    geom = pt.tile_geometry(128, 128, specs)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    draws = ct.draw_frames([g], geom, 128, 128)
    oy = torch.zeros(1, 128, 248, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        ct.candidate_tables_kernel(oy.long(), oy, draws, geom, 128, 128)
    with pytest.raises(ValueError, match="shape"):
        ct.candidate_tables_kernel(oy[:, :64], oy[:, :64], draws, geom, 128,
                                   128)
    with pytest.raises(ValueError, match="jitter"):
        ct.candidate_tables_kernel(
            oy, oy, draws._replace(jitter=draws.jitter.int()), geom, 128,
            128)


def _superres_256():
    from image_analogies_tpu_torch.utils.examples import super_resolution

    return (torch.as_tensor(x, device="cuda") for x in super_resolution(256))


def test_superres_run_with_k5_equals_the_plain_tables(dev, monkeypatch):
    """The super-resolution configuration at 256^2: K5 launches once for
    each K1 launch, and B' is bit for bit the run's with the plain
    builder forced in (K5 then never launches)."""
    from image_analogies_tpu_torch import create_image_analogy

    a, ap, b = _superres_256()
    cfg = SynthConfig(**SUPERRES)
    create_image_analogy(a, ap, b, cfg)  # builds and warms
    for counter in (pt.launches, pt.launches_banded, ct.launches):
        counter.reset()
    got = create_image_analogy(a, ap, b, cfg)
    # Tile levels 256^2 and 128^2, each em_iters x pm_iters sweeps.
    assert ct.launches.count == pt.launches.count == 2 * cfg.em_iters \
        * cfg.pm_iters
    assert pt.launches_banded.count == 0
    ct.launches.reset()
    monkeypatch.setattr(ct, "candidate_tables_kernel",
                        lambda *args: ct.candidate_tables_plain(*args))
    want = create_image_analogy(a, ap, b, cfg)
    assert ct.launches.count == 0
    assert torch.equal(got, want)


def test_sweep_phase_neither_syncs_nor_copies_on_the_host(dev):
    """Under `torch.profiler`, no host-side CUDA sync and no memcpy is
    issued inside any `tlm_sweep` range of a super-resolution run."""
    from torch.profiler import ProfilerActivity, profile

    from image_analogies_tpu_torch import create_image_analogy

    a, ap, b = _superres_256()
    cfg = SynthConfig(**SUPERRES)
    create_image_analogy(a, ap, b, cfg)  # builds and warms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        create_image_analogy(a, ap, b, cfg)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    sweeps = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "tlm_sweep"]
    assert len(sweeps) == 2 * cfg.em_iters
    launches = [e for e in events if e.name == "cudaLaunchKernel"]
    assert launches

    def inside(e):
        return any(t0 <= e.time_range.start and e.time_range.end <= t1
                   for t0, t1 in sweeps)

    assert any(inside(e) for e in launches)
    bad = sorted({e.name for e in events if inside(e) and (
        "Synchronize" in e.name or e.name.startswith("cudaMemcpy"))})
    assert bad == []

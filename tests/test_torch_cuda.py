"""The port's CUDA kernels against their plain PyTorch versions on the
card, over shapes and channel sets the main path's smoke check does not
cover: ragged tiles, A and B of different sizes, rgb and steerable
channel sets, a wider window, kappa > 1, tied and tiny tables.

Needs an NVIDIA GPU, nvcc and no JAX; skipped elsewhere.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.kernels import nn_brute as nb
from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
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


@pytest.mark.parametrize("h,w,ha,wa,n_src,n_flt,coarse,coh,kw", [
    (300, 500, 260, 380, 1, 1, True, 1.0, {}),
    (128, 128, 128, 128, 1, 1, False, 2.0, {}),
    (200, 260, 200, 260, 3, 3, True, 1.5, {"color_mode": "rgb"}),
    (256, 130, 192, 300, 5, 1, True, 1.0, {"steerable": True}),
    (192, 192, 256, 256, 1, 1, True, 1.2,
     {"patch_size": 7, "coarse_patch_size": 5}),
])
def test_tile_sweep_kernel_matches_plain(dev, h, w, ha, wa, n_src, n_flt,
                                         coarse, coh, kw):
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
                                       (5, 3, 17), (4096, 4100, 50)])
def test_nn_argmin_kernel_matches_plain(dev, n_b, n_a, d):
    rng = np.random.default_rng(n_b + n_a + d)
    f_b = _rand(rng, (n_b, d), dev)
    f_a = _rand(rng, (n_a, d), dev)
    a_sq = nb.squared_norms(f_a)
    idx_k = nb.nn_argmin_kernel(f_b, f_a, a_sq)
    idx_p = nb.nn_argmin_plain(f_b, f_a, a_sq)
    d_k, d_p = candidate_dist(f_b, f_a, idx_k), candidate_dist(f_b, f_a, idx_p)
    differ = idx_k != idx_p
    assert not bool((differ & ((d_k - d_p).abs() > 1e-5 * d_p.abs())).any())


def test_nn_argmin_kernel_first_index_ties(dev):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    base[550] = base[3]
    base[130] = base[100]
    f_a = torch.as_tensor(base, device=dev)
    f_b = f_a[[3, 550, 100, 130]].contiguous()
    idx = nb.nn_argmin_kernel(f_b, f_a, nb.squared_norms(f_a))
    assert idx.tolist() == [3, 3, 100, 100]
    const = torch.ones(300, 8, device=dev)
    idx = nb.nn_argmin_kernel(const[:70].contiguous(), const,
                              nb.squared_norms(const))
    assert idx.tolist() == [0] * 70


def test_kernel_wrappers_reject_bad_input(dev):
    f = torch.rand(10, 8, device=dev)
    with pytest.raises(ValueError):
        nb.nn_argmin_kernel(f.double(), f, nb.squared_norms(f))
    with pytest.raises(ValueError):
        nb.nn_argmin_kernel(f.t(), f.t(), nb.squared_norms(f.t()))
    with pytest.raises(NotImplementedError):
        nb.nn_argmin(f, f, match_dtype=torch.bfloat16)

"""The port's tensor ops against the JAX package on the same numpy inputs:
color, remap, pyramid, steerable, features and PCA, on the CPU.

Values agree to rtol 1e-5 / atol 1e-6 (float32 results of the same
arithmetic in two frameworks); feature layouts agree index for index."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.ops import color as j_color
from image_analogies_tpu.ops import features as j_feat
from image_analogies_tpu.ops import pca as j_pca
from image_analogies_tpu.ops import pyramid as j_pyr
from image_analogies_tpu.ops import remap as j_remap
from image_analogies_tpu.ops import steerable as j_steer
from image_analogies_tpu_torch.config import SynthConfig as TCfg
from image_analogies_tpu_torch.ops import color as t_color
from image_analogies_tpu_torch.ops import features as t_feat
from image_analogies_tpu_torch.ops import pca as t_pca
from image_analogies_tpu_torch.ops import pyramid as t_pyr
from image_analogies_tpu_torch.ops import remap as t_remap
from image_analogies_tpu_torch.ops import steerable as t_steer

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def img(rng, *shape):
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["rgb_to_yiq", "yiq_to_rgb", "luminance"])
def test_color(rng, fn):
    x = img(rng, 17, 23, 3)
    close(getattr(t_color, fn)(torch.from_numpy(x)),
          getattr(j_color, fn)(jnp.asarray(x)))


def test_remap(rng):
    y_a, y_ap, y_b = img(rng, 20, 24), img(rng, 20, 24), img(rng, 20, 24)
    got = t_remap.remap_luminance(*map(torch.from_numpy, (y_a, y_ap, y_b)))
    want = j_remap.remap_luminance(*map(jnp.asarray, (y_a, y_ap, y_b)))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("shape", [(33, 47), (32, 32, 3)])
def test_blur_and_downsample(rng, shape):
    x = img(rng, *shape)
    close(t_pyr.gaussian_blur(torch.from_numpy(x)),
          j_pyr.gaussian_blur(jnp.asarray(x)))
    close(t_pyr.downsample(torch.from_numpy(x)),
          j_pyr.downsample(jnp.asarray(x)))


@pytest.mark.parametrize(
    "src,dst", [((8, 8), (16, 16)), ((17, 9), (33, 17)), ((12, 13), (24, 25)),
                ((33, 33), (65, 65))]
)
def test_upsample_odd_targets(rng, src, dst):
    x = img(rng, *src)
    close(t_pyr.upsample(torch.from_numpy(x), dst),
          j_pyr.upsample(jnp.asarray(x), dst))
    xc = img(rng, *src, 3)
    close(t_pyr.upsample(torch.from_numpy(xc), dst),
          j_pyr.upsample(jnp.asarray(xc), dst))


def test_build_pyramid(rng):
    x = img(rng, 65, 50)
    got = t_pyr.build_pyramid(torch.from_numpy(x), 4)
    want = j_pyr.build_pyramid(jnp.asarray(x), 4)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("n_orient", [2, 4])
def test_steerable(rng, n_orient):
    y = img(rng, 21, 30)
    close(t_steer.steerable_responses(torch.from_numpy(y), n_orient),
          j_steer.steerable_responses(jnp.asarray(y), n_orient))


@pytest.mark.parametrize("patch,channels", [(5, None), (3, 2), (5, 3)])
def test_extract_patches_layout(rng, patch, channels):
    shape = (11, 14) if channels is None else (11, 14, channels)
    # Distinct integers make the comparison a layout check, index by index.
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = t_feat.extract_patches(torch.from_numpy(x), patch).numpy()
    want = np.asarray(j_feat.extract_patches(jnp.asarray(x), patch))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"gaussian_weighting": False},
                                {"patch_size": 7, "coarse_patch_size": 5}])
def test_feature_weights(kw):
    for has_coarse in (False, True):
        np.testing.assert_array_equal(
            t_feat.feature_weights(2, 1, TCfg(device="cpu", **kw), has_coarse),
            j_feat.feature_weights(2, 1, JCfg(**kw), has_coarse),
        )


@pytest.mark.parametrize("coarse,shape", [(False, (16, 18)), (True, (16, 18)),
                                          (True, (15, 17))])
def test_assemble_features(rng, coarse, shape):
    h, w = shape
    src, flt = img(rng, h, w, 2), img(rng, h, w)
    srcc = img(rng, (h + 1) // 2, (w + 1) // 2, 2) if coarse else None
    fltc = img(rng, (h + 1) // 2, (w + 1) // 2) if coarse else None
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    got = t_feat.assemble_features(t(src), t(flt), TCfg(device="cpu"),
                                   t(srcc), t(fltc))
    want = j_feat.assemble_features(j(src), j(flt), JCfg(), j(srcc), j(fltc))
    assert tuple(got.shape) == want.shape
    close(got, want)


@pytest.mark.parametrize("k", [3, 8])
def test_pca(rng, k):
    # Distinct, well-separated eigenvalues so the basis is unique up to
    # each column's sign.
    scales = np.linspace(3.0, 0.2, 12).astype(np.float32)
    x = (rng.standard_normal((500, 12)) * scales).astype(np.float32)
    got = t_pca.pca_basis(torch.from_numpy(x), k).numpy()
    want = np.asarray(j_pca.pca_basis(jnp.asarray(x), k))
    signs = np.sign((got * want).sum(axis=0))
    close(got * signs, want, rtol=1e-4, atol=1e-5)
    f = img(rng, 6, 7, 12)
    close(t_pca.project(torch.from_numpy(f), torch.from_numpy(np.array(want))),
          j_pca.project(jnp.asarray(f), jnp.asarray(want)))
    fa, basis = t_pca.fit_and_project(torch.from_numpy(f), None)
    assert basis is None and torch.equal(fa, torch.from_numpy(f))


def test_config_mirrors_reference():
    import dataclasses

    t_fields = {f.name: f.default for f in dataclasses.fields(TCfg)}
    j_fields = {f.name: f.default for f in dataclasses.fields(JCfg)}
    assert t_fields.pop("device") == "cuda"
    assert t_fields == j_fields
    for bad in ({"patch_size": 4}, {"levels": 0}, {"tau": -1.0},
                {"pallas_mode": "x"}, {"pca_dims": 0}, {"ann_eps": -1.0},
                {"color_mode": "hsv"}, {"pm_polish_iters": 0}):
        with pytest.raises(ValueError):
            JCfg(**bad)
        with pytest.raises(ValueError):
            TCfg(**bad)
    for shapes in (((256, 256),), ((48, 64), (100, 30))):
        assert TCfg(levels=5).clamp_levels(*shapes) == \
            JCfg(levels=5).clamp_levels(*shapes)


@pytest.mark.parametrize("name,size", [("texture_by_numbers", 40),
                                       ("artistic_filter", 33),
                                       ("super_resolution", 32),
                                       ("texture_transfer", 24)])
def test_examples_are_the_reference_copies(name, size):
    from image_analogies_tpu.utils import examples as j_ex
    from image_analogies_tpu_torch.utils import examples as t_ex

    for got, want in zip(getattr(t_ex, name)(size), getattr(j_ex, name)(size)):
        np.testing.assert_array_equal(got, want)

"""The port end to end on the CPU: config 1 (brute, which draws no random
numbers) against the JAX package's B'; PatchMatch on the per-pixel path
and on the tile path (K1's plain version) against the port's own brute
oracle at the reference tests' 33 dB gate; and a run resumed from the
JAX package's saved level state."""

import numpy as np
import pytest
import torch

from image_analogies_tpu import SynthConfig as JCfg
from image_analogies_tpu import create_image_analogy as j_create
from image_analogies_tpu.utils.examples import (
    super_resolution,
    texture_by_numbers,
)
from image_analogies_tpu_torch import SynthConfig, create_image_analogy, psnr
from image_analogies_tpu_torch.models.analogy import load_level_state


def port(a, ap, b, **kw):
    return create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw))


def test_config1_brute_against_jax():
    a, ap, b = texture_by_numbers(48)
    kw = dict(levels=3, matcher="brute", em_iters=2)
    got = port(a, ap, b, **kw).numpy()
    want = np.asarray(j_create(a, ap, b, JCfg(**kw)))
    assert got.shape == b.shape and got.std() > 0.05
    assert psnr(got, want) >= 40.0


def test_config3_per_pixel_path_against_oracle():
    a, ap, b = super_resolution(64)
    kw = dict(levels=3, em_iters=3)
    oracle = port(a, ap, b, matcher="brute", **kw)
    pm = port(a, ap, b, matcher="patchmatch", pm_iters=10, pallas_mode="off",
              **kw)
    assert psnr(pm, oracle) >= 33.0


def test_default_config_tile_path_against_oracle():
    """The default config at 128^2: level 0 takes the tile path with K1's
    plain version."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile

    a, ap, b = super_resolution(128)
    oracle = port(a, ap, b, matcher="brute")
    patchmatch_tile.launches.reset()
    pm = port(a, ap, b, pallas_mode="interpret")
    assert patchmatch_tile.launches.count == 0  # CPU: no kernel launch
    assert torch.isfinite(pm).all()
    assert psnr(pm, oracle) >= 33.0


def test_resume_from_jax_level_state(tmp_path):
    """The JAX package writes level_1.npz; the port resumes level 0 from
    it, and its level-0 field equals the JAX level-0 field except at
    ties."""
    a, ap, b = texture_by_numbers(48)
    kw = dict(levels=3, matcher="brute", em_iters=2)
    j_create(a, ap, b, JCfg(save_level_artifacts=str(tmp_path), **kw))
    state = load_level_state(str(tmp_path), 1, device="cpu")
    assert state.nnf.shape == (24, 24, 2)
    aux = create_image_analogy(
        a, ap, b, SynthConfig(device="cpu", **kw), return_aux=True,
        resume=state,
    )
    want = np.load(tmp_path / "level_0.npz")
    got_nnf = aux["nnf"][0].numpy()
    got_dist = aux["dist"][0].numpy()
    differ = (got_nnf != want["nnf"]).any(-1)
    np.testing.assert_allclose(got_dist, want["dist"], rtol=1e-5, atol=1e-6)
    assert differ.mean() < 0.01
    assert aux["nnf"][1] is state.nnf


@pytest.mark.parametrize("kw", [{"levels": 2, "color_mode": "rgb"},
                                {"levels": 2, "steerable": True},
                                {"levels": 2, "pca_dims": 6, "kappa": 2.0},
                                {"levels": 2, "match_dtype": "bfloat16"}])
def test_options_against_jax_brute(kw):
    """Brute runs of the other standard-path options against the JAX
    package's B' (bfloat16 matching: both argmins on bf16-rounded rows
    with float32 products)."""
    a, ap, b = texture_by_numbers(32)
    kw = dict(matcher="brute", em_iters=1, **kw)
    got = port(a, ap, b, **kw).numpy()
    want = np.asarray(j_create(a, ap, b, JCfg(**kw)))
    assert psnr(got, want) >= 40.0

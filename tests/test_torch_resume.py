"""Checkpoint writing and resume in the port, on the CPU: the
single-runner cases of the reference's tests/test_resume.py (a resumed
run reproduces the uninterrupted one bit for bit, all levels done, a
corrupt artifact skipped, a mismatched fingerprint rejected, an empty or
missing directory warned about or, strict, raised, the brute_lean_bytes
wildcard), plus the two packages against each other: equal fingerprint
strings for equal fields, and each package resuming from a directory the
other wrote, a lean level's stacked planes included."""

import logging
import os

import numpy as np
import pytest
import torch

from image_analogies_tpu import SynthConfig as JCfg
from image_analogies_tpu import create_image_analogy as j_create
from image_analogies_tpu.models import analogy as jan
from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch.models import analogy as tan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and a full thread pool in each would oversubscribe
    the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, n=32):
    a = rng.random((n, n)).astype(np.float32)
    ap = np.clip(a * 0.5 + 0.2, 0, 1).astype(np.float32)
    b = rng.random((n, n)).astype(np.float32)
    return a, ap, b


def run(a, ap, b, resume_from=None, strict=False, **kw):
    out = create_image_analogy(
        a, ap, b, SynthConfig(device="cpu", **kw), resume_from=resume_from,
        resume_strict=strict,
    )
    return out.numpy()


@pytest.mark.parametrize("kw", [
    dict(matcher="patchmatch", em_iters=2, pm_iters=3),
    dict(matcher="brute", em_iters=1, brute_lean_bytes=1),
])
def test_resume_reproduces_full_run(tmp_path, rng, kw):
    """A run resumed after level 1 equals the uninterrupted run; the
    brute case resumes a lean level from its stacked planes."""
    a, ap, b = _inputs(rng, n=64)
    ckpt = str(tmp_path / "ckpt")
    full = run(a, ap, b, levels=3, save_level_artifacts=ckpt, **kw)
    assert sorted(os.listdir(ckpt)) == [f"level_{i}.npz" for i in range(3)]
    with np.load(os.path.join(ckpt, "level_0.npz")) as z:
        assert z["nnf"].dtype == np.int32 and z["nnf"].shape == (64, 64, 2)
        assert z["dist"].dtype == z["bp"].dtype == np.float32
    os.unlink(os.path.join(ckpt, "level_0.npz"))
    resumed = run(a, ap, b, levels=3, resume_from=ckpt, **kw)
    np.testing.assert_array_equal(resumed, full)


def test_resume_with_all_levels_done_returns_final(tmp_path, rng):
    a, ap, b = _inputs(rng)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(levels=2, matcher="brute", em_iters=1)
    full = run(a, ap, b, save_level_artifacts=ckpt, **kw)
    out = create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw),
                               resume_from=ckpt, return_aux=True)
    np.testing.assert_array_equal(out["bp"].numpy(), full)
    assert out["nnf"][0].shape == (32, 32, 2)
    assert out["nnf"][0].dtype == torch.int64


def test_resume_skips_corrupt_artifact(tmp_path, rng):
    a, ap, b = _inputs(rng)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(levels=3, matcher="brute", em_iters=1)
    full = run(a, ap, b, save_level_artifacts=ckpt, **kw)
    with open(os.path.join(ckpt, "level_0.npz"), "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    np.testing.assert_array_equal(run(a, ap, b, resume_from=ckpt, **kw),
                                  full)


def test_resume_rejects_mismatched_checkpoint(tmp_path, rng):
    a, ap, b = _inputs(rng)
    ckpt = str(tmp_path / "ckpt")
    run(a, ap, b, levels=2, matcher="brute", em_iters=1,
        save_level_artifacts=ckpt)
    kw2 = dict(levels=2, matcher="patchmatch", em_iters=1, seed=9)
    np.testing.assert_array_equal(run(a, ap, b, resume_from=ckpt, **kw2),
                                  run(a, ap, b, **kw2))
    a2, ap2, b2 = _inputs(rng, n=16)
    out = run(a2, ap2, b2, resume_from=ckpt, levels=2, matcher="brute",
              em_iters=1)
    assert out.shape == b2.shape
    # No fingerprint: skipped too.
    with np.load(os.path.join(ckpt, "level_0.npz")) as z:
        np.savez(os.path.join(ckpt, "level_0.npz"), nnf=z["nnf"],
                 dist=z["dist"], bp=z["bp"])
    reasons = []
    got = tan._load_resume_state(
        ckpt, 2, tan._ckpt_fingerprint(
            SynthConfig(device="cpu", levels=2, matcher="brute",
                        em_iters=1), b.shape),
        SynthConfig(device="cpu"), reasons=reasons)
    assert got[0] == 1 and reasons == ["level_0.npz: no run fingerprint"]


def test_resume_from_empty_dir_is_fresh_run(tmp_path, rng, caplog):
    a, ap, b = _inputs(rng)
    kw = dict(levels=2, matcher="brute", em_iters=1)
    with caplog.at_level(logging.WARNING,
                         logger="image_analogies_tpu_torch"):
        got = run(a, ap, b, resume_from=str(tmp_path / "nothing"), **kw)
    np.testing.assert_array_equal(got, run(a, ap, b, **kw))
    assert any("no usable checkpoint" in r.message for r in caplog.records)


@pytest.mark.parametrize("make,says", [
    (lambda p: None, "does not exist"),
    (lambda p: os.makedirs(p), "no level_*.npz"),
])
def test_strict_resume_of_nothing_raises_like_jax(tmp_path, make, says):
    path = str(tmp_path / "dir")
    make(path)
    with pytest.raises(tan.ResumeError) as mine:
        tan.resume_prologue(path, 3, SynthConfig(device="cpu"), (32, 32),
                            strict=True)
    with pytest.raises(jan.ResumeError) as ref:
        jan.resume_prologue(path, 3, JCfg(), (32, 32), None, strict=True)
    assert says in str(mine.value)
    assert str(mine.value) == str(ref.value)


def test_strict_resume_names_fingerprint_mismatch(tmp_path, rng):
    a, ap, b = _inputs(rng)
    ckpt = str(tmp_path / "ckpt")
    run(a, ap, b, levels=2, matcher="brute", em_iters=1,
        save_level_artifacts=ckpt)
    other = SynthConfig(device="cpu", levels=2, matcher="brute", em_iters=1,
                        seed=9)
    with pytest.raises(tan.ResumeError) as exc:
        tan.resume_prologue(ckpt, 2, other, b.shape, strict=True)
    assert "fingerprint mismatch" in str(exc.value)
    assert "seed=9" in str(exc.value)
    assert tan.resume_prologue(ckpt, 2, other, b.shape) is None
    with pytest.raises(ValueError, match="not both"):
        create_image_analogy(a, ap, b, other, resume_from=ckpt,
                             resume=tan.load_level_state(ckpt, 1, "cpu"))


def test_fingerprint_scopes_brute_lean_bytes_to_brute_matcher():
    shape = (64, 64)

    def fp(**kw):
        return tan._ckpt_fingerprint(SynthConfig(**kw), shape)

    pm_new = SynthConfig(matcher="patchmatch", brute_lean_bytes=2**33)
    saved = fp(matcher="patchmatch", brute_lean_bytes=2**34)
    expected = tan._ckpt_fingerprint(pm_new, shape)
    assert saved != expected
    assert tan._fingerprint_matches(saved, expected, pm_new)
    br_new = SynthConfig(matcher="brute", brute_lean_bytes=2**33)
    assert not tan._fingerprint_matches(
        fp(matcher="brute", brute_lean_bytes=2**34),
        tan._ckpt_fingerprint(br_new, shape), br_new)
    assert not tan._fingerprint_matches(
        fp(matcher="patchmatch", patch_size=7), expected, pm_new)


@pytest.mark.parametrize("kw,shape", [
    ({}, (32, 32)),
    (dict(matcher="brute", kappa=2.0, levels=3, seed=7), (48, 40, 3)),
    (dict(pca_dims=6, steerable=True, color_mode="rgb",
          save_level_artifacts="/ckpt", pallas_mode="interpret",
          brute_chunk=128, match_dtype="bfloat16"), (64, 64)),
    (dict(feature_bytes_budget=1, brute_lean_bytes=5, tau=0.0,
          pm_polish_final_only=False, gaussian_weighting=False), (16, 24)),
])
def test_fingerprint_equals_jax(kw, shape):
    """Equal fields give the reference's string; the port-only `device`
    is not in it."""
    want = jan._ckpt_fingerprint(JCfg(**kw), shape)
    for dev in ("cuda", "cpu"):
        got = tan._ckpt_fingerprint(SynthConfig(device=dev, **kw),
                                    torch.Size(shape))
        assert got == want
    assert "device" not in want


def test_port_checkpoints_resume_in_jax(tmp_path, rng):
    """A port-written directory (a lean brute level 0 among standard
    levels) is accepted by the reference's loader, array for array."""
    a, ap, b = _inputs(rng, n=64)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(levels=3, matcher="brute", em_iters=1)
    aux = create_image_analogy(
        a, ap, b, SynthConfig(device="cpu", save_level_artifacts=ckpt,
                              brute_lean_bytes=2_000_000, **kw),
        return_aux=True)
    # Level 0 (64^2) took the lean path, levels 1 and 2 the standard one.
    assert isinstance(aux["nnf"][0], tuple)
    assert not isinstance(aux["nnf"][1], tuple)
    reasons = []
    cfg = JCfg(brute_lean_bytes=2_000_000, **kw)
    got = jan._load_resume_state(
        ckpt, 3, jan._ckpt_fingerprint(cfg, b.shape), cfg, reasons=reasons)
    assert reasons == [] and got is not None
    best, nnf, dist, bp, fill = got
    assert best == 0 and sorted(fill) == [0, 1, 2]
    np.testing.assert_array_equal(
        np.asarray(nnf), torch.stack(aux["nnf"][0], -1).numpy())
    np.testing.assert_array_equal(np.asarray(dist), aux["dist"][0].numpy())
    np.testing.assert_array_equal(np.asarray(fill[1][0]),
                                  aux["nnf"][1].numpy())


def test_jax_checkpoints_resume_in_port(tmp_path, rng):
    """A JAX-written directory whose level 1 is lean (stacked planes on
    disk) resumes in the port: level 0 is recomputed from it, and the
    port's B' is the JAX B' up to float ties."""
    from image_analogies_tpu_torch import psnr

    a, ap, b = _inputs(rng)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(levels=3, matcher="brute", em_iters=1, brute_lean_bytes=1)
    want = np.asarray(j_create(a, ap, b,
                               JCfg(save_level_artifacts=ckpt, **kw)))
    os.unlink(os.path.join(ckpt, "level_0.npz"))
    out = create_image_analogy(a, ap, b, SynthConfig(device="cpu", **kw),
                               resume_from=ckpt, return_aux=True,
                               resume_strict=True)
    with np.load(os.path.join(ckpt, "level_1.npz")) as z:
        np.testing.assert_array_equal(out["nnf"][1].numpy(), z["nnf"])
    assert isinstance(out["nnf"][0], tuple)
    assert psnr(out["bp"].numpy(), want) >= 40.0

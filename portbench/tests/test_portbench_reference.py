"""CPU tests of the plain reference and its control, at sizes a test run
holds: the exact-search oracle against the program's own brute matcher,
the judge on the program's answers, and the bfloat16 control failing
the render check.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest
import torch

from portbench import gen
from portbench import reference as ref


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(size=48, seed=2**33 + 5):
    a, ap, bs = gen.super_resolution_pool(size, seed, 1)
    return a, ap, bs[0]


def _prepared(a, ap, b, spec, dtype=torch.float32, b_stats=None):
    t = torch.as_tensor
    return ref.prepare(t(a), t(ap), t(b), spec, b_stats=b_stats, dtype=dtype)


def test_pools_are_made_from_the_seed():
    one, two = _inputs(seed=11), _inputs(seed=11)
    other = _inputs(seed=12)
    for x, y in zip(one, two):
        assert (x == y).all()
    assert not (one[2] == other[2]).all()
    a, ap, seqs = gen.npr_sequences(2, 3, 32, 2**40)
    assert a.shape == ap.shape == (32, 32, 3)
    assert [s.shape for s in seqs] == [(3, 32, 32, 3)] * 2
    assert not (seqs[0] == seqs[1]).all()


def test_the_frozen_generators_equal_the_programs():
    from image_analogies_tpu_torch.utils import examples

    a, ap, bs = gen.super_resolution_pool(40, 9, 1)
    for x, y in zip((a, ap, bs[0]), examples.super_resolution(40, 9)):
        assert (x == y).all()
    a, ap, seqs = gen.npr_sequences(1, 3, 40, 9)
    for x, y in zip((a, ap, seqs[0]), examples.npr_frames(3, 40, 9)):
        assert (x == y).all()


@pytest.mark.parametrize("kappa", [0.0, 2.0])
def test_the_oracle_agrees_with_the_programs_brute_matcher(kappa):
    """The reference's exact search against the program's brute path on
    the same inputs: the same field but for float ties."""
    from image_analogies_tpu_torch import SynthConfig, create_image_analogy

    a, ap, b = _inputs()
    spec = ref.Spec(levels=3, em_iters=2, kappa=kappa)
    want = create_image_analogy(
        a, ap, b, SynthConfig(matcher="brute", device="cpu", levels=3,
                              em_iters=2, kappa=kappa), return_aux=True)
    p = _prepared(a, ap, b, spec)
    got, nnf = ref.oracle(p, spec, chunk=500)
    assert ref.psnr(got, want["bp"]) >= 55.0
    assert (nnf == want["nnf"][0]).all(-1).float().mean() >= 0.95
    judged = ref.judge(want["bp"], want["nnf"][0], p, spec, got)
    assert judged["render_max_abs"] < 1e-6
    assert judged["psnr_db"] >= 55.0
    # The brute field is the exact search's but for ties and the last
    # EM step's B': no match far off.
    assert judged["match_far_share"] < 1e-3


def test_the_judge_holds_a_patchmatch_answer_and_its_stack_statistics():
    from image_analogies_tpu_torch import SynthConfig, synthesize_batch

    a, ap, seqs = gen.npr_sequences(1, 2, 40, 77)
    cfg = SynthConfig(device="cpu", levels=2, em_iters=2, kappa=2.0)
    out, nnf = synthesize_batch(a, ap, seqs[0], cfg, frames_per_step=1,
                                return_nnf=True)
    spec = ref.Spec(levels=2, em_iters=2, kappa=2.0)
    stack = ref.stats(ref.rgb_to_yiq(torch.as_tensor(seqs[0]))[..., 0])
    for f in range(2):
        p = _prepared(a, ap, seqs[0][f], spec, b_stats=stack)
        oracle_out, _ = ref.oracle(p, spec)
        got = ref.judge(out[f], torch.as_tensor(nnf[f]), p, spec,
                        oracle_out)
        assert got["render_max_abs"] < 1e-5
        assert got["psnr_db"] > 30.0
        # The frame's own statistics in place of the stack's: rejected.
        own = _prepared(a, ap, seqs[0][f], spec)
        assert ref.judge(out[f], torch.as_tensor(nnf[f]), own, spec,
                         oracle_out)["render_max_abs"] > 1e-3


def test_a_field_outside_a_is_rejected():
    a, ap, b = _inputs(size=32)
    spec = ref.Spec(levels=2)
    p = _prepared(a, ap, b, spec)
    out, nnf = ref.oracle(p, spec)
    bad = nnf.clone()
    bad[0, 0, 0] = 32
    assert ref.judge(out, bad, p, spec, out)["render_max_abs"] == float("inf")
    assert ref.judge(out, bad, p, spec)["match_far_share"] == 1.0
    assert ref.judge(out[:-1], nnf, p, spec, out)["psnr_db"] == float("-inf")


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**40 + 1])
def test_the_bfloat16_control_fails_the_render_limit(seed):
    """The control: the reference in the program's place, one precision
    below the configuration's float32, judged as the program is."""
    import json

    from portbench import spec as pspec

    limits = json.loads(
        (pspec.PKG / "configs" / "superres.json").read_text())["correct"]
    a, ap, b = _inputs(size=48, seed=seed)
    spec = ref.Spec(levels=3, em_iters=2)
    p32 = _prepared(a, ap, b, spec)
    want, _ = ref.oracle(p32, spec)
    got, nnf = ref.oracle(_prepared(a, ap, b, spec, torch.bfloat16), spec)
    judged = ref.judge(got.float(), nnf, p32, spec, want)
    assert judged["render_max_abs"] > 10 * limits["render_max_abs_max"]
    assert judged["match_far_share"] > limits["match_far_share_max"]


def test_match_far_share_reads_a_worse_field_higher():
    """The oracle's field leaves no match far off; a field of random
    matches leaves many, and a sample of the pixels reads close to all of
    them."""
    a, ap, b = _inputs(size=48, seed=2**35 + 3)
    spec = ref.Spec(levels=3, em_iters=2)
    p = _prepared(a, ap, b, spec)
    _, nnf = ref.oracle(p, spec)
    assert ref.match_far_share(p, spec, nnf) < 1e-3
    shifted = torch.randint(0, 48, nnf.shape,
                            generator=torch.Generator().manual_seed(5))
    worse = ref.match_far_share(p, spec, shifted)
    assert worse > 0.05
    sample = ref.sample_rows(48 * 48, 1200, seed=4)
    assert sample is not None and len(set(sample.tolist())) == 1200
    assert abs(ref.match_far_share(p, spec, shifted, sample) - worse) < 0.03
    assert ref.sample_rows(48 * 48, 48 * 48, seed=4) is None

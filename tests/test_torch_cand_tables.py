"""Kernel K5 (`kernels/cand_tables.py`): every frame's K1 candidate
tables for one tile sweep in one launch, and the dispatch that picks it.

On the CPU (tier 1):
- `draw_frames` stacks each frame's `draw_candidates` bit for bit, and
  the frame-axis plain builder equals `sample_candidates_blocked` frame
  by frame bit for bit (one frame and three, uniform and coarse
  restarts, at 128^2 and at 200 x 300, which no tile divides);
- the dispatch rule of `candidate_tables`, the wrapper refusing CPU
  tensors, the source in `SOURCES`;
- no launch on the CPU and, with the rule's device test faked to "CUDA"
  and the kernel replaced by an exact stand-in, one launch a sweep for
  all frames, as many as K1's, and the same B';
- `tile_patchmatch_lean`'s (py, px, dist) equal to those of the
  per-frame table loop it replaced, for one frame and three, with the
  PCA prune and under the coarse restart mode.

On the card: `tests/test_torch_cuda.py` holds the kernel to the plain
builder bit for bit at the benchmark's geometries.
"""

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch import kernels
from image_analogies_tpu_torch.kernels import cand_tables as ct
from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
from image_analogies_tpu_torch.models import patchmatch as t_pm
from image_analogies_tpu_torch.parallel.batch import synthesize_batch
from image_analogies_tpu_torch.telemetry.spans import Tracer
from torch_modes import set_modes  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(n_f, seed):
    gens = []
    for i in range(n_f):
        g = torch.Generator()
        g.manual_seed(seed + i)
        gens.append(g)
    return gens


def _state(rng, n_f, geom, h, w, ha, wa):
    """Frame-stacked compact (oy, ox) planes of random fields over A."""
    qy = torch.arange(h)[:, None]
    qx = torch.arange(w)[None, :]

    def plane(hi, q):
        return torch.stack([
            pt.to_compact((torch.as_tensor(rng.integers(0, hi, (h, w)))
                           - q).to(torch.int32), geom)
            for _ in range(n_f)])

    return plane(ha, qy), plane(wa, qx)


# --------------------------------------------------------- the tables


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("n_f", [1, 3])
@pytest.mark.parametrize("h,w,ha,wa,n_src", [
    (128, 128, 128, 128, 1),
    (200, 300, 150, 260, 1),
    (200, 300, 260, 140, 5),
])
def test_frame_builder_equals_per_frame_tables(h, w, ha, wa, n_src, n_f,
                                               coarse):
    specs = pt.channel_specs(n_src, 1, SynthConfig(steerable=n_src == 5),
                             True)
    geom = pt.tile_geometry(h, w, specs)
    rng = np.random.default_rng(h + w + n_f)
    oy, ox = _state(rng, n_f, geom, h, w, ha, wa)
    draws = ct.draw_frames(_gens(n_f, 7), geom, ha, wa, coarse)
    assert (draws.restart is not None) == coarse
    want = []
    for i, g in enumerate(_gens(n_f, 7)):
        one = pt.draw_candidates(g, geom, ha, wa, coarse)
        for got_x, one_x in zip(ct.frame_draws(draws, i), one):
            assert (got_x is None) == (one_x is None)
            assert got_x is None or torch.equal(got_x, one_x)
        want.append(pt.sample_candidates_blocked(oy[i], ox[i], one, geom,
                                                 ha, wa))
    shape = (n_f, geom.n_ty, geom.n_tx, pt.K_TOTAL)
    for plain in (False, True):
        got = ct.candidate_tables(oy, ox, draws, geom, ha, wa, plain=plain)
        for g, tabs in zip(got, zip(*want)):
            assert g.dtype == torch.int32 and tuple(g.shape) == shape
            assert g.is_contiguous()
            assert torch.equal(g, torch.stack(tabs))
    # The dedup marks some slots (the neighbours' samples repeat on a
    # grid of few tiles) and keeps every first one.
    valid = got[2]
    assert bool((valid[..., 0] == 1).all())
    assert int(valid.sum()) < valid.numel()


@pytest.mark.parametrize("on_card,plain,launched", [
    (True, False, True), (True, True, False), (False, False, False),
    (False, True, False),
])
def test_tables_engine_rule(monkeypatch, on_card, plain, launched):
    """`candidate_tables` launches the kernel only on CUDA state planes
    and not `plain`; either way the tables are the plain builder's."""
    calls = []
    monkeypatch.setattr(ct, "on_cuda", lambda t: on_card)
    monkeypatch.setattr(ct, "candidate_tables_kernel", stand_in(calls))
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    geom = pt.tile_geometry(128, 128, specs)
    oy, ox = _state(np.random.default_rng(1), 2, geom, 128, 128, 128, 128)
    draws = ct.draw_frames(_gens(2, 0), geom, 128, 128)
    got = ct.candidate_tables(oy, ox, draws, geom, 128, 128, plain=plain)
    assert calls == ([2] if launched else [])
    want = ct.candidate_tables_plain(oy, ox, draws, geom, 128, 128)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_wrapper_refuses_cpu_tensors_and_counts_nothing():
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    geom = pt.tile_geometry(128, 128, specs)
    oy, ox = _state(np.random.default_rng(0), 1, geom, 128, 128, 128, 128)
    draws = ct.draw_frames(_gens(1, 0), geom, 128, 128)
    before = ct.launches.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        ct.candidate_tables_kernel(oy, ox, draws, geom, 128, 128)
    assert ct.launches.count == before


def test_source_is_registered():
    (entry, argtypes), = kernels.SOURCES["cand_tables"].items()
    assert entry == "ia_cand_tables" and len(argtypes) == 18
    assert (kernels.CSRC / "cand_tables.cu").exists()


# ------------------------------------------------- the matcher's route

RUN = dict(device="cpu", levels=2, em_iters=1, pm_iters=2, kappa=0.5)


def _scene(seed, size=128, frames=0):
    rng = np.random.default_rng(seed)
    shape = (frames, size, size) if frames else (size, size)
    a = rng.random((size, size)).astype(np.float32)
    ap = np.clip(0.7 * a + 0.2 * rng.random((size, size)), 0, 1) \
        .astype(np.float32)
    return a, ap, rng.random(shape).astype(np.float32)


def _run(frames, **kw):
    a, ap, b = _scene(5, frames=frames)
    cfg = SynthConfig(**RUN, **kw)
    if frames:
        return synthesize_batch(a, ap, b, cfg)
    return create_image_analogy(a, ap, b, cfg)


def stand_in(calls):
    """An exact CPU stand-in for `candidate_tables_kernel` that records
    each launch's frame count: the plain builder."""
    def kernel(off_y, off_x, draws, geom, ha, wa):
        calls.append(off_y.shape[0])
        return ct.candidate_tables_plain(off_y, off_x, draws, geom, ha, wa)

    return kernel


@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("fake_card", [False, True])
def test_sweep_spans_name_the_tables_engine(monkeypatch, frames, fake_card):
    """On the CPU K5 never launches; with the card faked, it launches
    once a sweep for all frames, inside a `sweep` span, as often as K1;
    B' is the CPU route's either way."""
    want = _run(frames)
    calls, sweeps = [], []
    if fake_card:
        monkeypatch.setattr(ct, "on_cuda", lambda t: True)
        monkeypatch.setattr(ct, "candidate_tables_kernel", stand_in(calls))
    real = pt.tile_sweep

    def spy(*args, **kw):
        sweeps.append(args[1].shape[0] if args[1].ndim == 4 else 1)
        return real(*args, **kw)

    monkeypatch.setattr(pt, "tile_sweep", spy)
    tracer = Tracer()
    a, ap, b = _scene(5, frames=frames)
    cfg = SynthConfig(**RUN)
    got = (synthesize_batch(a, ap, b, cfg, progress=tracer) if frames
           else create_image_analogy(a, ap, b, cfg, progress=tracer))
    assert tracer.find("sweep")
    # Level 0 is the only tile level: em_iters x pm_iters sweeps.
    assert len(sweeps) == RUN["em_iters"] * RUN["pm_iters"]
    assert calls == (sweeps if fake_card else [])
    assert torch.equal(got, want)


def _parent_loop(monkeypatch):
    """The per-frame table loop K5 replaced: each frame's draws from its
    generator, its tables by `sample_candidates_blocked`, then stacked."""
    def draw_frames(gens, geom, ha, wa, coarse_restarts=False):
        return list(gens), coarse_restarts

    def candidate_tables(oy, ox, gens_coarse, geom, ha, wa, *, plain=False):
        gens, coarse = gens_coarse
        tabs = [pt.sample_candidates_blocked(
            oy[i], ox[i], pt.draw_candidates(g, geom, ha, wa, coarse), geom,
            ha, wa) for i, g in enumerate(gens)]
        return tuple(torch.stack(t) for t in zip(*tabs))

    monkeypatch.setattr(ct, "draw_frames", draw_frames)
    monkeypatch.setattr(ct, "candidate_tables", candidate_tables)


@pytest.mark.parametrize("frames,restart,prune", [
    (0, "uniform", "off"), (3, "uniform", "off"), (3, "coarse", "off"),
    (0, "coarse", "8:16"), (3, "uniform", "8:16"),
])
def test_lean_matcher_equals_the_per_frame_table_loop(monkeypatch, set_modes,
                                                      frames, restart, prune):
    set_modes(restart=restart, prune=prune)
    real = t_pm.tile_patchmatch_lean
    fields, images = {}, {}
    for route in ("k5_route", "parent_loop"):
        with monkeypatch.context() as m:
            seen = fields[route] = []

            def spy(*args, **kw):
                out = real(*args, **kw)
                seen.append(out)
                return out

            m.setattr(t_pm, "tile_patchmatch_lean", spy)
            if route == "parent_loop":
                _parent_loop(m)
            images[route] = _run(frames)
    assert len(fields["k5_route"]) == len(fields["parent_loop"]) > 0
    for got, want in zip(fields["k5_route"], fields["parent_loop"]):
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert torch.equal(images["k5_route"], images["parent_loop"])

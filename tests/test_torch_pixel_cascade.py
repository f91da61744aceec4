"""Kernel K4 (`kernels/pixel_cascade.py`): one sweep of the per-pixel
PatchMatch cascade a launch, and the entry point that picks it
(`cascade_sweeps`).

On the CPU (tier 1):
- the entry point's rule and, with its device test faked to "CUDA" and
  the kernel replaced by an exact stand-in, the route every caller
  takes: one launch a sweep for the per-pixel path and the sequential
  bf16 polish; the eager cascade for "interpret", the temporal term,
  the stream and int8 polish fetches and a caller's own `dist_fn`;
  fields bit for bit those of the plain route;
- `cascade_sweeps` with `dist_fn=None` bit for bit the explicit default
  distance, and `patchmatch_sweeps` with the default distance the
  `candidate_dist` closure it used to build;
- a small CPU run launching no K4, the source in `SOURCES` and in
  `sources_digest`, and the wrapper refusing CPU tensors.

On the card (`-m cuda`, skipped elsewhere): K4 against its plain
version bit for bit on integer-valued tables (every sum exact in any
order, ties included), at the super-resolution widths and at those of
steerable-filter features, within float32 rounding on the super-resolution
features of a real run, repeatable bit for bit, one launch a sweep where
the rule says so and none elsewhere, and the wrapper's input checks.
On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_pixel_cascade.py
"""

import hashlib

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch import kernels
from image_analogies_tpu_torch.config import EngineModes
from image_analogies_tpu_torch.kernels import pixel_cascade as pc
from image_analogies_tpu_torch.models import patchmatch as pm
from image_analogies_tpu_torch.models.matcher import (
    candidate_dist,
    candidate_dist_lean,
)
from image_analogies_tpu_torch.telemetry import metrics as t_metrics
from image_analogies_tpu_torch.telemetry.spans import Tracer
from torch_modes import set_modes  # noqa: F401 (a fixture)

cuda = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registry():
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    yield reg
    t_metrics.set_registry(prev)


def tables(rng, h, w, ha, wa, d, dtype=torch.float32, pad=0, integer=False,
           device="cpu"):
    """(H W, d) B and (ha wa, d + pad) A tables; pad columns hold 7s,
    which no distance may read."""
    def draw(n, k):
        x = (rng.integers(0, 5, (n, k)) if integer
             else rng.random((n, k))).astype(np.float32)
        return torch.as_tensor(x)

    f_b = draw(h * w, d)
    f_a = torch.cat([draw(ha * wa, d), torch.full((ha * wa, pad), 7.0)], 1)
    return f_b.to(dtype).to(device), f_a.to(dtype).to(device)


def field(rng, h, w, ha, wa, device="cpu"):
    """A random (py, px) field reaching past A on every side."""
    py = torch.as_tensor(rng.integers(-3, ha + 3, (h, w)), device=device)
    px = torch.as_tensor(rng.integers(-3, wa + 3, (h, w)), device=device)
    return py, px


def offsets(rng, sweeps, n_random, h, w, ha, wa, device="cpu"):
    radii = pm.sweep_radii(ha, wa, n_random)
    return [
        torch.stack([torch.as_tensor(rng.integers(-r, r + 1, (h, w, 2)))
                     for r in radii]).to(device)
        if radii else torch.zeros(0, h, w, 2, dtype=torch.long,
                                  device=device)
        for _ in range(sweeps)
    ]


def stand_in(calls):
    """An exact CPU stand-in for `cascade_sweep_kernel` that records its
    calls: the plain sweep under the default distance, the incoming
    match's distance first where `dist` is None."""
    def kernel(f_b_tab, f_a_tab, py, px, dist, off, *, ha, wa,
               coh_factor):
        calls.append((tuple(py.shape), f_a_tab.dtype))

        def dist_fn(idx):
            return candidate_dist_lean(f_b_tab, f_a_tab, idx)

        py, px = py.clamp(0, ha - 1), px.clamp(0, wa - 1)
        if dist is None:
            dist = dist_fn((py * wa + px).reshape(-1)).reshape(py.shape)
        return pc.cascade_sweep_plain(py, px, dist, off, ha=ha, wa=wa,
                                      coh_factor=coh_factor, dist_fn=dist_fn)

    return kernel


@pytest.fixture
def fake_card(monkeypatch):
    """The entry point's device test says "CUDA" and the kernel is the
    exact stand-in; yields the stand-in's calls."""
    calls = []
    monkeypatch.setattr(pc, "on_cuda", lambda t: True)
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    return calls


# ------------------------------------------------------------ the rule


@pytest.mark.parametrize("on_card,plain,default_dist,launched", [
    (True, False, True, True),
    (True, True, True, False),
    (True, False, False, False),
    (False, False, True, False),
    (False, True, False, False),
])
def test_sweep_engine_rule(monkeypatch, on_card, plain, default_dist,
                           launched):
    """`cascade_sweeps` launches the kernel, once a sweep, only on CUDA
    tables under the default distance and not `plain`."""
    calls = []
    monkeypatch.setattr(pc, "on_cuda", lambda t: on_card)
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    rng = np.random.default_rng(14)
    f_b, f_a = tables(rng, 6, 5, 4, 4, 3)
    py, px = field(rng, 6, 5, 4, 4)
    pc.cascade_sweeps(
        f_b, f_a, py, px, offsets(rng, 2, 2, 6, 5, 4, 4), ha=4, wa=4,
        coh_factor=1.0, plain=plain,
        dist_fn=None if default_dist
        else lambda idx: candidate_dist_lean(f_b, f_a, idx))
    assert len(calls) == (2 if launched else 0)


def test_cpu_tables_run_plain_and_book_nothing(registry, monkeypatch):
    calls = []
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    rng = np.random.default_rng(0)
    f_b, f_a = tables(rng, 12, 10, 9, 11, 6)
    py, px = field(rng, 12, 10, 9, 11)
    before = pc.launches.count
    pc.cascade_sweeps(f_b, f_a, py, px, offsets(rng, 2, 3, 12, 10, 9, 11),
                      ha=9, wa=11, coh_factor=1.5)
    assert calls == [] and pc.launches.count == before
    assert "ia_kernel_launches_total" not in registry.to_dict()


def test_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    f_b, f_a = tables(rng, 6, 5, 4, 4, 3)
    py, px = field(rng, 6, 5, 4, 4)
    before = pc.launches.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        pc.cascade_sweep_kernel(f_b, f_a, py, px, None,
                                offsets(rng, 1, 2, 6, 5, 4, 4)[0], ha=4,
                                wa=4, coh_factor=1.0)
    assert pc.launches.count == before


# ------------------------------------------------- routes, faked card

SWEEPS, N_RANDOM = 3, 4


def _pixel_case(rng, route):
    """The per-pixel path's `patchmatch_sweeps` under `route`: (kwargs,
    f_b, f_a, nnf) at 16 x 18 against a 14 x 15 A."""
    h, w, ha, wa, d = 16, 18, 14, 15, 9
    f_b = torch.as_tensor(rng.random((h, w, d)).astype(np.float32))
    f_a = torch.as_tensor(rng.random((ha, wa, d)).astype(np.float32))
    nnf = torch.stack(field(rng, h, w, ha, wa), -1)
    kw = {}
    if route == "plain":
        kw["plain"] = True
    elif route == "temporal":
        kw.update(temporal=torch.stack(field(rng, h, w, ha, wa), -1),
                  tau=0.3)
    elif route == "gather":
        kw["gather_fn"] = lambda tab, ix: tab.index_select(0, ix)
    offs = offsets(rng, SWEEPS, N_RANDOM, h, w, ha, wa)
    return kw, f_b, f_a, nnf, offs


@pytest.mark.parametrize("route,launched", [
    ("default", SWEEPS),
    ("plain", 0),
    ("temporal", 0),
    ("gather", 0),
])
def test_pixel_path_routes(monkeypatch, route, launched):
    """`patchmatch_sweeps` on a faked card: one launch a sweep under the
    default distance, else the eager cascade; the field and distances
    bit for bit those of the unfaked (CPU) run."""
    kw, f_b, f_a, nnf, offs = _pixel_case(np.random.default_rng(2), route)
    want = pm.patchmatch_sweeps(f_b, f_a, nnf, offs, coh_factor=1.5, **kw)
    calls = []
    monkeypatch.setattr(pc, "on_cuda", lambda t: True)
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    got = pm.patchmatch_sweeps(f_b, f_a, nnf, offs, coh_factor=1.5, **kw)
    assert len(calls) == launched
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_caller_dist_fn_stays_eager(fake_card):
    rng = np.random.default_rng(3)
    f_b, f_a = tables(rng, 10, 12, 11, 9, 5)
    py, px = field(rng, 10, 12, 11, 9)
    offs = offsets(rng, SWEEPS, 2, 10, 12, 11, 9)
    got = pc.cascade_sweeps(
        f_b, f_a, py, px, offs, ha=11, wa=9, coh_factor=1.0,
        dist_fn=lambda idx: candidate_dist_lean(f_b, f_a, idx))
    assert fake_card == []
    want = pc.cascade_sweeps(f_b, f_a, py, px, offs, ha=11, wa=9,
                             coh_factor=1.0, plain=True)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def _polish(route, cand_dtype="bf16"):
    """`_merge_and_polish` at 20 x 24 against an 18 x 22 A, bf16 tables
    (one column of pad on A), under a polish `route`."""
    rng = np.random.default_rng(4)
    h, w, ha, wa = 20, 24, 18, 22
    f_b, f_a = tables(rng, h, w, ha, wa, 7, torch.bfloat16, pad=1)
    py, px = (t.clamp(0, m - 1) for t, m in
              zip(field(rng, h, w, ha, wa), (ha, wa)))
    ky, kx = (t.clamp(0, m - 1) for t, m in
              zip(field(rng, h, w, ha, wa), (ha, wa)))

    def dist_fn(idx):
        return candidate_dist_lean(f_b, f_a, idx)

    dist0 = dist_fn((py * wa + px).reshape(-1)).reshape(h, w)
    mode = "stream" if route == "stream" else "sequential"
    return pm._merge_and_polish(
        py, px, dist0, ky, kx, pm.SweepDraws(5, 0, 1), dist_fn, f_b, f_a,
        cfg=SynthConfig(device="cpu", kappa=0.0), plain=route == "plain",
        ha=ha, wa=wa, coh=1.25, pm_iters=2, polish_iters=2, polish_random=3,
        modes=EngineModes(cand_dtype=cand_dtype, polish=mode),
        default_dist=route != "dist_fn")


@pytest.mark.parametrize("route,cand_dtype,launched", [
    ("sequential", "bf16", 2),
    ("stream", "bf16", 0),
    ("sequential", "int8", 0),
    ("dist_fn", "bf16", 0),
    ("plain", "bf16", 0),
])
def test_polish_routes(monkeypatch, route, cand_dtype, launched):
    """The tile path's polish on a faked card: the sequential bf16
    polish launches once a sweep; the stream and int8 fetches, a
    caller's `dist_fn` and "interpret" stay eager; the result bit for
    bit the unfaked run's."""
    want = _polish(route, cand_dtype)
    calls = []
    monkeypatch.setattr(pc, "on_cuda", lambda t: True)
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    got = _polish(route, cand_dtype)
    assert len(calls) == launched
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_zero_sweeps_return_the_incoming_distance(fake_card):
    rng = np.random.default_rng(5)
    f_b, f_a = tables(rng, 8, 9, 7, 6, 4)
    py, px = field(rng, 8, 9, 7, 6)
    got = pc.cascade_sweeps(f_b, f_a, py, px, [], ha=7, wa=6,
                            coh_factor=1.0)
    cy, cx = py.clamp(0, 6), px.clamp(0, 5)
    assert fake_card == []
    assert torch.equal(got[0], cy) and torch.equal(got[1], cx)
    assert torch.equal(got[2], candidate_dist_lean(
        f_b, f_a, (cy * 6 + cx).reshape(-1)).reshape(8, 9))


# -------------------------------------------- the default distance


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coh,n_random,pad", [
    (1.0, 0, 0), (1.5, 6, 0), (2.0, 3, 5)])
def test_default_distance_equals_the_explicit_one(dtype, coh, n_random, pad):
    rng = np.random.default_rng(6)
    h, w, ha, wa = 13, 17, 15, 12
    f_b, f_a = tables(rng, h, w, ha, wa, 10, dtype, pad=pad)
    py, px = field(rng, h, w, ha, wa)
    offs = offsets(rng, 3, n_random, h, w, ha, wa)
    got = pc.cascade_sweeps(f_b, f_a, py, px, offs, ha=ha, wa=wa,
                            coh_factor=coh)
    want = pc.cascade_sweeps(
        f_b, f_a, py, px, offs, ha=ha, wa=wa, coh_factor=coh,
        dist_fn=lambda idx: candidate_dist_lean(f_b, f_a, idx))
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("coh", [1.0, 1.75])
def test_pixel_sweeps_default_equals_candidate_dist(coh):
    """`patchmatch_sweeps` with neither a gather nor the temporal term
    takes the tables' default distance; bit for bit the `candidate_dist`
    closure it passed before K4."""
    rng = np.random.default_rng(7)
    h, w, ha, wa, d = 18, 14, 16, 19, 11
    f_b = torch.as_tensor(rng.random((h, w, d)).astype(np.float32))
    f_a = torch.as_tensor(rng.random((ha, wa, d)).astype(np.float32))
    nnf = torch.stack(field(rng, h, w, ha, wa), -1)
    offs = offsets(rng, 3, 4, h, w, ha, wa)
    nnf_t, d_t = pm.patchmatch_sweeps(f_b, f_a, nnf, offs, coh_factor=coh)
    fb, fa = f_b.reshape(-1, d), f_a.reshape(-1, d)
    py, px, dist = pc.cascade_sweeps(
        fb, fa, nnf[..., 0], nnf[..., 1], offs, ha=ha, wa=wa,
        coh_factor=coh, dist_fn=lambda idx: candidate_dist(fb, fa, idx))
    assert torch.equal(nnf_t, torch.stack([py, px], -1))
    assert torch.equal(d_t, dist)


# ------------------------------------------------------ spans, sources

RUN = dict(device="cpu", levels=2, matcher="patchmatch", em_iters=2,
           pm_iters=2, kappa=0.5)


def _images(side=128):
    rng = np.random.default_rng(8)
    a = rng.random((side, side)).astype(np.float32)
    return a, np.clip(a * 0.5 + 0.2, 0, 1), rng.random(
        (side, side)).astype(np.float32)


def test_cpu_run_spans_name_the_eager_engine(monkeypatch):
    """A CPU run launches no K4: its two pixel spans and its polish span
    are there, and neither the kernel nor its counter is touched."""
    calls = []
    monkeypatch.setattr(pc, "cascade_sweep_kernel", stand_in(calls))
    tracer = Tracer()
    before = pc.launches.count
    create_image_analogy(*_images(), SynthConfig(**RUN), progress=tracer)
    assert len(tracer.find("pixel")) == 2 and len(tracer.find("polish")) == 1
    assert calls == [] and pc.launches.count == before


def test_faked_card_run_launches_once_a_sweep(fake_card):
    """A 128^2 run (tile path at 128^2, per-pixel sweeps at 64^2) on a
    faked card: the launches are the sweeps (em_iters x pm_iters at
    64^2, the final EM step's polish sweeps at 128^2); B' is the CPU
    run's."""
    cfg = SynthConfig(**RUN)
    got = create_image_analogy(*_images(), cfg)
    assert sorted(fake_card) == sorted(
        [((64, 64), torch.float32)] * cfg.em_iters * cfg.pm_iters
        + [((128, 128), torch.bfloat16)] * cfg.pm_polish_iters)
    want = create_image_analogy(*_images(), cfg)
    assert torch.equal(got, want)


def test_source_is_built_and_digested(monkeypatch, tmp_path):
    assert "pixel_cascade" in kernels.SOURCES
    (entry, argtypes), = kernels.SOURCES["pixel_cascade"].items()
    assert entry == "ia_pixel_cascade" and len(argtypes) == 21
    assert (kernels.CSRC / "pixel_cascade.cu").exists()
    h = hashlib.sha256()
    for name in sorted(kernels.SOURCES):
        h.update((kernels.CSRC / f"{name}.cu").read_bytes())
    assert kernels.sources_digest() == h.hexdigest()[:16]
    # An edit to K4's source alone moves the digest.
    for name in kernels.SOURCES:
        text = (kernels.CSRC / f"{name}.cu").read_bytes()
        if name == "pixel_cascade":
            text += b"\n"
        (tmp_path / f"{name}.cu").write_bytes(text)
    before = kernels.sources_digest()
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert kernels.sources_digest() != before


# ----------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(f_b, f_a, py, px, offs, ha, wa, coh):
    """(kernel, plain) results of the cascade on the same CUDA inputs."""
    before = pc.launches.count
    got = pc.cascade_sweeps(f_b, f_a, py, px, offs, ha=ha, wa=wa,
                            coh_factor=coh)
    assert pc.launches.count == before + len(offs)
    want = pc.cascade_sweeps(f_b, f_a, py, px, offs, ha=ha, wa=wa,
                             coh_factor=coh, plain=True)
    torch.cuda.synchronize()
    return got, want


@cuda
@pytest.mark.parametrize("pad", [0, 6])
@pytest.mark.parametrize("n_random", [0, 6])
@pytest.mark.parametrize("coh", [1.0, 1.5])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 50),
                                     (torch.bfloat16, 68)])
@pytest.mark.parametrize("h,w,ha,wa", [(64, 64, 64, 64), (61, 67, 70, 59),
                                       (128, 256, 128, 256)])
def test_kernel_equals_plain_on_integer_tables(dev, h, w, ha, wa, dtype, d,
                                               coh, n_random, pad):
    """Small integers: every distance is exact in any summation order,
    and ties are everywhere, so the fields, the accept decisions and the
    distances must be the plain version's bit for bit."""
    rng = np.random.default_rng(h * 1000 + w + n_random + pad)
    f_b, f_a = tables(rng, h, w, ha, wa, d, dtype, pad=pad, integer=True,
                      device=dev)
    py, px = field(rng, h, w, ha, wa, dev)
    offs = offsets(rng, 3, n_random, h, w, ha, wa, dev)
    got, want = _both(f_b, f_a, py, px, offs, ha, wa, coh)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@cuda
@pytest.mark.parametrize("coh", [1.0, 1.5])
@pytest.mark.parametrize("side,dtype,d,n_random", [
    (64, torch.float32, 150, 6),
    (1024, torch.bfloat16, 204, 4),
])
def test_kernel_equals_plain_at_steerable_widths(dev, side, dtype, d,
                                                 n_random, coh):
    """The widths of steerable-filter features (luminance and 4 oriented
    responses on the source side): the 64^2 per-pixel level's float32
    rows of 6 x 25 = 150 with its 6 probes, and the 1024^2 polish's bf16
    rows of 6 x 25 + 6 x 9 = 204 with its 4; bit for bit the plain
    version on integer tables, as at the narrower widths."""
    rng = np.random.default_rng(side * 1000 + d)
    f_b, f_a = tables(rng, side, side, side, side, d, dtype, integer=True,
                      device=dev)
    py, px = field(rng, side, side, side, side, dev)
    offs = offsets(rng, 2, n_random, side, side, side, side, dev)
    got, want = _both(f_b, f_a, py, px, offs, side, side, coh)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def _captured(dev):
    """The first K4 launch's tables and field at each shape of a 256^2
    super-resolution run (64^2 per-pixel float32 tables, the 256^2 and
    128^2 polish's bf16 ones), keyed by (h, w)."""
    from image_analogies_tpu_torch.utils.examples import super_resolution

    seen = {}
    real = pc.cascade_sweep_kernel

    def spy(f_b, f_a, py, px, dist, off, **kw):
        if dist is None and py.shape not in seen:
            seen[tuple(py.shape)] = (f_b.clone(), f_a.clone(), py.clone(),
                                     px.clone(), kw["ha"], kw["wa"],
                                     kw["coh_factor"], off.shape[0])
        return real(f_b, f_a, py, px, dist, off, **kw)

    a, ap, b = (torch.as_tensor(x, device=dev)
                for x in super_resolution(256))
    pc.cascade_sweep_kernel = spy
    try:
        create_image_analogy(a, ap, b, SynthConfig(levels=3, em_iters=2))
    finally:
        pc.cascade_sweep_kernel = real
    return seen


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _captured(torch.device("cuda"))


@cuda
@pytest.mark.parametrize("shape,sweeps", [((64, 64), 6), ((256, 256), 2)])
def test_kernel_on_real_features(captured, shape, sweeps):
    """The main path's own tables: the returned distances are those of
    the returned field (float64 over the same rows) within rtol 1e-6;
    99 % of pixels hold the plain version's match; the mean distance
    within 1e-3 relative of the plain version's."""
    f_b, f_a, py, px, ha, wa, coh, n_random = captured[shape]
    h, w = shape
    rng = np.random.default_rng(9)
    offs = offsets(rng, sweeps, n_random, h, w, ha, wa, f_b.device)
    (ky, kx, kd), (qy, qx, qd) = _both(f_b, f_a, py, px, offs, ha, wa, coh)
    d = f_b.shape[1]
    rows = f_a[(ky * wa + kx).reshape(-1), :d].double()
    exact = ((f_b.double() - rows) ** 2).sum(-1).reshape(h, w)
    assert torch.allclose(kd.double(), exact, rtol=1e-6, atol=0.0)
    same = ((ky == qy) & (kx == qx)).double().mean().item()
    assert same >= 0.99, same
    mean_k, mean_q = kd.double().mean().item(), qd.double().mean().item()
    assert abs(mean_k - mean_q) <= 1e-3 * mean_q


@cuda
def test_kernel_repeats_its_bits(captured):
    for (h, w), (f_b, f_a, py, px, ha, wa, coh, n_random) in \
            captured.items():
        offs = offsets(np.random.default_rng(10), 2, n_random, h, w, ha, wa,
                       f_b.device)
        runs = [pc.cascade_sweeps(f_b, f_a, py, px, offs, ha=ha, wa=wa,
                                  coh_factor=coh)
                for _ in range(2)]
        for g, x in zip(*runs):
            assert torch.equal(g, x), (h, w)


@cuda
@pytest.mark.parametrize("route,launched", [
    ("default", SWEEPS),
    ("plain", 0),
    ("temporal", 0),
    ("gather", 0),
])
def test_pixel_path_launches_on_the_card(dev, registry, route, launched):
    kw, f_b, f_a, nnf, offs = _pixel_case(np.random.default_rng(11), route)
    if "temporal" in kw:
        kw["temporal"] = kw["temporal"].to(dev)
    before = pc.launches.count
    pm.patchmatch_sweeps(f_b.to(dev), f_a.to(dev), nnf.to(dev),
                         [o.to(dev) for o in offs], coh_factor=1.5, **kw)
    torch.cuda.synchronize()
    assert pc.launches.count == before + launched
    got = registry.counter("ia_kernel_launches_total").value(
        labels={"kernel": "pixel_cascade"})
    assert got == launched


@cuda
@pytest.mark.parametrize("polish,cand_dtype,polish_launches", [
    ("sequential", "bf16", True),
    ("stream", "bf16", False),
    ("sequential", "int8", False),
])
def test_run_launches_once_a_sweep_on_the_card(dev, monkeypatch, set_modes,
                                               polish, cand_dtype,
                                               polish_launches):
    """A 128^2 run on the card: the 64^2 level's sweeps launch K4 in
    every mode; the 128^2 polish launches it only as the sequential bf16
    engine, else its sweeps run eagerly; under "interpret" nothing
    launches."""
    set_modes(cand_dtype=cand_dtype, polish=polish)
    shapes = []
    real = pc.cascade_sweep_kernel

    def spy(f_b, f_a, py, *args, **kw):
        shapes.append(tuple(py.shape))
        return real(f_b, f_a, py, *args, **kw)

    monkeypatch.setattr(pc, "cascade_sweep_kernel", spy)
    a, ap, b = (torch.as_tensor(x, device=dev) for x in _images())
    cfg = SynthConfig(**{**RUN, "device": "cuda"})
    pixel = cfg.em_iters * cfg.pm_iters
    before = pc.launches.count
    create_image_analogy(a, ap, b, cfg)
    torch.cuda.synchronize()
    polished = cfg.pm_polish_iters if polish_launches else 0
    assert pc.launches.count == before + pixel + polished
    assert sorted(shapes) == [(64, 64)] * pixel + [(128, 128)] * polished
    before = pc.launches.count
    create_image_analogy(a, ap, b, SynthConfig(
        **{**RUN, "device": "cuda", "pallas_mode": "interpret"}))
    assert pc.launches.count == before


@cuda
def test_caller_dist_fn_never_launches_on_the_card(dev, registry):
    rng = np.random.default_rng(12)
    f_b, f_a = tables(rng, 32, 32, 32, 32, 8, device=dev)
    py, px = field(rng, 32, 32, 32, 32, dev)
    before = pc.launches.count
    pc.cascade_sweeps(
        f_b, f_a, py, px, offsets(rng, 2, 3, 32, 32, 32, 32, dev), ha=32,
        wa=32, coh_factor=1.0,
        dist_fn=lambda idx: candidate_dist_lean(f_b, f_a, idx))
    assert pc.launches.count == before
    assert "ia_kernel_launches_total" not in registry.to_dict()


@cuda
def test_kernel_wrapper_rejects_bad_input(dev):
    rng = np.random.default_rng(13)
    h, w, ha, wa = 16, 20, 18, 14
    f_b, f_a = tables(rng, h, w, ha, wa, 9, device=dev)
    py, px = field(rng, h, w, ha, wa, dev)
    off = offsets(rng, 1, 2, h, w, ha, wa, dev)[0]
    kw = dict(ha=ha, wa=wa, coh_factor=1.0)
    call = pc.cascade_sweep_kernel
    cases = [
        ((f_b, f_a, py.cpu(), px, None, off), "CUDA tensor"),
        ((f_b.double(), f_a.double(), py, px, None, off), "float32 or bf16"),
        ((f_b, f_a.to(torch.bfloat16), py, px, None, off), "expected"),
        ((f_b[:-1], f_a, py, px, None, off), "shape"),
        ((f_b, f_a[:, :5], py, px, None, off), "narrower"),
        ((f_b, f_a, py.int(), px, None, off), "int64"),
        ((f_b, f_a, py.t().contiguous().t()[:h, :w], px, None, off),
         "contiguous"),
        ((f_b, f_a, py, px, torch.zeros(h, w + 1, device=dev), off),
         "shape"),
        ((f_b, f_a, py, px, None, off[..., :1]), "shape"),
        ((torch.cat([f_b, f_b], 1)[:, :9], f_a, py, px, None, off),
         "contiguous"),
    ]
    before = pc.launches.count
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            call(*args, **kw)
    assert pc.launches.count == before

"""The `steerable` configuration's support (BASELINE config 4): the plain
steerable reference of the benchmark (`portbench/reference_steerable.py`)
against the port, its judge and bfloat16 control, the cell's two new
metric readers, the cell's driver through the run's own path on the CPU,
and the port's `steer` spans, `sweep` span attributes and K1 plan
counter.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_steerable_reference.py -q
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import gen, judge, run, spec
from portbench import reference_steerable as steer
from portbench import workcount as wc

CELL = "steerable.1024.single"
CONFIG = json.loads((spec.PKG / "configs" / "steerable.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(size, seed):
    a, ap, bs = gen.super_resolution_pool(size, seed, 1)
    return a, ap, bs[0]


def _synth(**over):
    return {**CONFIG["synth"], **over}


def _prepared(a, ap, b, sp, dtype=torch.float32):
    t = torch.as_tensor
    return steer.prepare(t(a), t(ap), t(b), sp, dtype=dtype)


# ------------------------------------------------------------ the bank


@pytest.mark.parametrize("h,w,n", [(40, 37, 4), (64, 64, 4), (33, 50, 6)])
def test_the_bank_equals_the_programs(h, w, n):
    """The reference's bank, written from the method's description,
    against the program's `ops/steerable.py` on seeded random luminance:
    within rtol 1e-5 of the response scale (float32 rounding of a 25-tap
    sum)."""
    from image_analogies_tpu_torch.ops.steerable import steerable_responses

    y = torch.rand(h, w, generator=torch.Generator().manual_seed(h * w))
    want = steer.responses(y.double(), n)
    got = steerable_responses(y, n).double()
    assert got.shape == want.shape == (h, w, n)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_the_bank_is_a_unit_norm_first_derivative():
    taps = steer.bank(4)
    assert taps.shape == (4, 5, 5)
    # Orientation 0 is the x derivative and pi/2 the y derivative, each
    # of unit norm, odd about the centre.
    assert abs((taps[0] ** 2).sum() - 1.0) < 1e-12
    assert abs((taps[2] ** 2).sum() - 1.0) < 1e-12
    assert np.allclose(taps[0], -taps[0][:, ::-1])
    assert np.allclose(taps[2], taps[0].T)


def test_feature_rows_are_204_wide_and_150_at_the_coarsest():
    a, ap, b = _inputs(32, 5)
    sp = steer.Spec.from_synth(_synth(levels=2))
    p = _prepared(a, ap, b, sp)
    assert [s.shape[-1] for s in p.s_a + p.s_b] == [5] * 4
    fine = steer.features(p.s_a[0], p.y_ap[0], p.s_a[1], p.y_ap[1], sp)
    top = steer.features(p.s_a[1], p.y_ap[1], None, None, sp)
    assert fine.shape == (32 * 32, 204)
    assert top.shape == (16 * 16, 150)


def test_the_spec_refuses_what_it_does_not_cover():
    with pytest.raises(ValueError):
        steer.Spec.from_synth(_synth(steerable=False))
    with pytest.raises(ValueError):
        steer.Spec.from_synth(_synth(color_mode="rgb"))
    assert steer.Spec.from_synth(CONFIG["synth"]).em_iters == 3


# ---------------------------------------------- the program against it


def test_the_oracle_agrees_with_the_programs_brute_matcher():
    """The reference's exact search against the program's brute path
    with steerable features on the same inputs: the same field, B'
    within 1e-5."""
    from image_analogies_tpu_torch import SynthConfig, create_image_analogy

    a, ap, b = _inputs(48, 2**33 + 5)
    sp = steer.Spec(levels=3, em_iters=2)
    want = create_image_analogy(
        a, ap, b, SynthConfig(matcher="brute", device="cpu", levels=3,
                              em_iters=2, steerable=True), return_aux=True)
    p = _prepared(a, ap, b, sp)
    got, nnf = steer.oracle(p, sp, chunk=500)
    assert torch.equal(nnf, want["nnf"][0].long())
    assert float((got - want["bp"]).abs().max()) <= 1e-5
    judged = steer.judge(want["bp"], want["nnf"][0], p, sp, got)
    assert judged["render_max_abs"] <= 1e-5
    assert judged["match_far_share"] == 0.0


@pytest.fixture(scope="module")
def patchmatch_run():
    """The program's PatchMatch answer at 128^2 with the configuration's
    knobs (2 levels; level 0 on the tile path, the plain K1 at 12
    channels), traced."""
    from image_analogies_tpu_torch import SynthConfig, create_image_analogy
    from image_analogies_tpu_torch.telemetry.spans import Tracer

    a, ap, b = _inputs(128, 2**33 + 9)
    synth = _synth(levels=2)
    tracer = Tracer()
    out = create_image_analogy(
        a, ap, b, SynthConfig(**synth, device="cpu", seed=2**35 + 1),
        return_aux=True, progress=tracer)
    return SimpleNamespace(a=a, ap=ap, b=b, synth=synth, out=out,
                           tracer=tracer)


def test_the_judge_holds_the_programs_patchmatch_answer(patchmatch_run):
    r = patchmatch_run
    sp = steer.Spec.from_synth(r.synth)
    p = _prepared(r.a, r.ap, r.b, sp)
    got = steer.judge(r.out["bp"], r.out["nnf"][0], p, sp)
    assert set(got) == {"render_max_abs", "match_far_share"}
    assert got["render_max_abs"] <= CONFIG["correct"]["render_max_abs_max"]
    assert got["match_far_share"] < CONFIG["correct"]["match_far_share_max"]


def test_the_sweep_spans_carry_the_steerable_plan(patchmatch_run):
    """Every tile sweep at 12 channels takes 8-row strips; the prologue
    opens one `steer` span a side."""
    sweeps = patchmatch_run.tracer.find("sweep")
    assert len(sweeps) == CONFIG["synth"]["em_iters"]
    for s in sweeps:
        assert s.attrs == {"channels": 12, "strip_rows": 8}
    steers = patchmatch_run.tracer.find("steer")
    assert [s.attrs for s in steers] == [{"side": "a"}, {"side": "b"}]


def test_no_steer_span_without_the_bank():
    from image_analogies_tpu_torch import SynthConfig, create_image_analogy
    from image_analogies_tpu_torch.telemetry.spans import Tracer

    a, ap, b = _inputs(32, 3)
    tracer = Tracer()
    create_image_analogy(a, ap, b, SynthConfig(device="cpu", levels=2,
                                               em_iters=1),
                         progress=tracer)
    assert tracer.find("steer") == []
    assert tracer.find("prologue")


def test_the_sweep_attributes_follow_the_strip_plan():
    from image_analogies_tpu_torch import SynthConfig
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt

    cfg = SynthConfig(device="cpu")
    for n_src, chans, rows in ((1, 4, 16), (5, 12, 8)):
        specs = pt.channel_specs(n_src, 1, cfg, True)
        geom = pt.tile_geometry(256, 256, specs)
        assert pt.sweep_attrs(specs, geom) == {"channels": chans,
                                               "strip_rows": rows}
        assert rows == pt.sweep_plan(chans, geom.halo)


@pytest.mark.parametrize("chans,rows", [(4, 16), (12, 8)])
def test_each_k1_launch_books_one_launch_and_its_fetch_bytes(chans, rows):
    """A launch at either strip plan books one `tile_sweep` launch and
    its fetches' bytes at that plan's window, as one unit."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile as pt
    from image_analogies_tpu_torch.telemetry import metrics as t_metrics

    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        pt.book_launch(10, chans, rows, 2, "bf16")
        pt.book_launch(10, chans, rows, 2, "bf16")
    finally:
        t_metrics.set_registry(prev)
    assert reg.counter("ia_kernel_launches_total").value(
        labels={"kernel": "tile_sweep"}) == 2
    moved, useful = pt.candidate_window_bytes_per_fetch(chans, rows, 2,
                                                        "bf16")
    dma = reg.counter("ia_candidate_dma_bytes_total")
    assert dma.value(labels={"kind": "useful", "dtype": "bf16"}) == (
        2 * 10 * useful)
    assert dma.value(labels={"kind": "padded", "dtype": "bf16"}) == (
        2 * 10 * (moved - useful))


# ---------------------------------------------------------- the control


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**40 + 1])
def test_the_bfloat16_control_fails_a_check(seed):
    """The reference in the program's place one precision below the
    configuration's float32, judged as the program is: at least one
    number beyond its limit (the render, by far)."""
    a, ap, b = _inputs(48, seed)
    sp = steer.Spec(levels=3, em_iters=3)
    p32 = _prepared(a, ap, b, sp)
    want, _ = steer.oracle(p32, sp)
    got, nnf = steer.oracle(_prepared(a, ap, b, sp, torch.bfloat16), sp)
    judged = steer.judge(got.float(), nnf, p32, sp, want)
    checks = {name: {"value": judged[name],
                     "limit": CONFIG["correct"][key], "holds": how}
              for name, (key, how) in judge.LIMITS.items()}
    assert not all(judge.holds(c) for c in checks.values())
    assert judged["render_max_abs"] > 10 * CONFIG["correct"][
        "render_max_abs_max"]


# --------------------------------------------------------- the readers


class _Span:
    def __init__(self, device_ms):
        self.device_ms = device_ms


class _Tracer:
    def __init__(self, spans):
        self.spans = spans

    def find(self, name):
        return self.spans.get(name, [])


def _ctx(spans=None, ops=None, frames=1):
    cell = spec.Cell(spec.load_benchmark(), CELL)
    return {"cell": cell, "traced": {
        "tracer": _Tracer(spans or {}), "span_frames": frames,
        "profiled_frames": frames, "trace": {"ops": ops or {}}}}


def test_steer_ms_reads_the_steer_spans_device_time():
    read = spec.metric_reader("steer_ms_per_frame")
    assert read(_ctx()) is None  # the parent opens no `steer` span
    assert read(_ctx({"steer": [_Span(None), _Span(1.0)]})) is None
    assert read(_ctx({"steer": [_Span(1.5), _Span(2.5)]}, frames=2)) == 2.0


def test_k1_steer_roofline_counts_from_the_cell_files_alone():
    """The least time of the unit's K1 sweeps at 12 channels (70 FLOP a
    candidate), from the configuration, the reference's level count and
    the mix's side; None without K1 in the trace."""
    read = spec.metric_reader("k1_steer_roofline")
    assert read(_ctx(ops={"void at::native::gather<3>()": 5.0})) is None
    assert wc.k1_flop_per_candidate(6, 6, 5, 3) == 70
    assert wc.k1_flop_per_candidate(6, 0, 5, 3) == 39
    # Levels 1024, 512, 256 and 128 run the tile path with the coarse
    # pair, 64 does not; 3 EM steps x 6 sweeps (no A past 4 Mpx).
    want = 0.0
    for side in (1024, 512, 256, 128):
        f, nbytes = wc.k1_sweep_work(side, side, side, side, 1, True,
                                     n_src=5, n_flt=1)
        assert f == side * side * 36 * 70
        want += 18 * max(f / wc.PEAK_FP32_FLOPS, nbytes / wc.PEAK_BYTES)
    ops = {"void tile_sweep_kernel<2, float, 8, true>(Args)": 20.0,
           "void at::native::gather<3>()": 5.0}
    got = read(_ctx(ops=ops))
    assert abs(got - 100.0 * want * 1e3 / 20.0) < 1e-12
    assert 0.0 < got < 100.0


# ------------------------------------------------- the cell on the CPU


def test_the_cell_is_declared_and_resolves():
    bench = spec.load_benchmark()
    assert spec.problems(bench) == []
    cell = spec.Cell(bench, CELL)
    assert cell.chips == 1 and cell.config["synth"]["steerable"] is True
    assert [m["name"] for m in cell.per_layer()] == [
        "prologue_ms_per_frame", "level_ms_per_frame",
        "device_ops_per_frame", "device_idle_frac", "em_step_ms_per_frame",
        "polish_ms_per_frame", "match_host_ms_per_frame",
        "steer_ms_per_frame", "k1_steer_roofline"]
    assert [m["name"] for m in cell.end_to_end()] == [
        "setup_s", "frames_per_s", "device_peak_gib"]


@pytest.fixture
def in_suite(monkeypatch):
    """The suite's conftest loads JAX into every test process, so the
    run's own refusal of JAX is held in a fresh process
    (`test_a_run_of_the_cell_loads_neither_jax_nor_the_jax_package`) and
    left out here."""
    monkeypatch.setattr(run, "forbidden_modules", lambda modules=None: [])


@pytest.mark.parametrize("trace", [False, True])
def test_run_cell_drives_the_steerable_cell_on_the_cpu(in_suite, trace):
    cell = spec.Cell(spec.load_benchmark(), CELL)
    cell.mix.update(size=48, pool=2)
    cell.config["synth"]["levels"] = 2
    res = run.run_cell(cell, 2**34 + 11, 0.01, trace, device="cpu",
                       t0=0.0, log=sys.stderr)
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["metrics"] == {}
    assert list(res["checks"]) == ["render_max_abs", "match_far_share",
                                   "psnr_db"]
    assert res["checks"]["psnr_db"]["limit"] == 33.0
    if trace:
        assert set(res["cpu_readings"]) >= {"prologue_ms_per_frame",
                                            "level_ms_per_frame"}


def test_a_run_of_the_cell_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from portbench import run, spec\n"
        f"cell = spec.Cell(spec.load_benchmark(), {CELL!r})\n"
        "cell.mix.update(size=32, pool=1)\n"
        "cell.config['synth']['levels'] = 2\n"
        "res = run.run_cell(cell, 3, 0.01, True, device='cpu', t0=0.0)\n"
        "print(run.forbidden_modules(), res['correct'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_a_state_left_unchanged_is_not_correct(in_suite, monkeypatch):
    from image_analogies_tpu_torch.models import analogy

    def unchanged(cfg, level, has_coarse, lean=False, polish_iters=None):
        def step(src_b, flt_b, src_b_c, flt_b_c, f_a, copy_a, nnf, draws,
                 proj=None, a_planes=None, plan=None, temporal=None):
            return nnf, torch.zeros(flt_b.shape), flt_b
        return step

    monkeypatch.setattr(analogy, "make_em_step", unchanged)
    cell = spec.Cell(spec.load_benchmark(), CELL)
    cell.mix.update(size=48, pool=2)
    cell.config["synth"]["levels"] = 2
    res = run.run_cell(cell, 7, 0.01, False, device="cpu", t0=0.0,
                       log=sys.stderr)
    assert res["correct"] is False
    assert not judge.holds(res["checks"]["render_max_abs"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", [
    "reference_steerable.py", "control_steerable.py",
    "drivers/library_single_steerable.py",
    "metrics/steer_ms_per_frame.py", "metrics/k1_steer_roofline.py"])
def test_the_new_files_import_neither_jax_nor_either_package(name):
    bad = {"jax", "jaxlib", "flax", "image_analogies_tpu",
           "image_analogies_tpu_torch"}
    assert not set(_imports(spec.PKG / name)) & bad

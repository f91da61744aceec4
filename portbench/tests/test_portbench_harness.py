"""CPU tests of the benchmark harness: names and files found by name, a
cell added as data alone, each driver at a tiny size through the run's
own path (no device metric printed), the rate's arithmetic, faults that
must turn `correct` false, and the imports the benchmark may not make.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import judge, run, spec
from portbench.drivers import Driver

ROOT = spec.ROOT
PKG = spec.PKG
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]

# Tiny shapes for the CPU: the mix's and configuration's sizes cut down,
# everything else as the files have it.
TINY_MIX = {"size": 48, "frames": 2, "frames_per_step": 1, "pool": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny(cell: spec.Cell) -> spec.Cell:
    cell.mix.update({k: v for k, v in TINY_MIX.items() if k in cell.mix})
    cell.config["synth"]["levels"] = 2
    return cell


def cpu_run(cell, seed=7, seconds=0.01, trace=False):
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        t0=0.0, log=sys.stderr)


def test_benchmark_names_files_and_units():
    bench = spec.load_benchmark()
    assert spec.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for m in bench["end_to_end"]:
        assert 0.0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = spec.Cell(spec.load_benchmark(), name)
    assert cell.config["name"] == cell.entry["config"]
    assert callable(spec.driver_module(cell.mix["driver"]).make)
    assert cell.per_layer() and cell.end_to_end()
    for m in cell.per_layer():
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "x" * 65, ".x",
                                 "µs"])
def test_bad_names_are_refused(bad):
    bench = spec.load_benchmark()
    bench["workloads"][0]["name"] = bad
    assert any("bad name" in p for p in spec.problems(bench))


@pytest.mark.parametrize("unit", ["tokens per second", "µs", ""])
def test_bad_units_are_refused(unit):
    bench = spec.load_benchmark()
    bench["end_to_end"][0]["unit"] = unit
    assert any("bad unit" in p for p in spec.problems(bench))


def test_a_cell_added_as_data_alone_is_found_and_run(tmp_path):
    """A new mix file and a new `workloads` entry, in a copy of the
    benchmark's files: found by name and run, with no code edited."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((pkg / "mixes" / "single.1024.json").read_text())
    mix.update(size=40, pool=3)
    (pkg / "mixes" / "single.40.json").write_text(json.dumps(mix))
    bench = spec.load_benchmark()
    bench["workloads"].append({
        "name": "superres.40.single", "config": "superres",
        "traffic": "single.40", "chips": 1, "why": "added as data"})
    assert spec.problems(bench, root=ROOT, pkg=pkg) == []
    cell = spec.Cell(bench, "superres.40.single", pkg=pkg)
    cell.config["synth"]["levels"] = 2
    res = cpu_run(cell)
    assert res["correct"] is True
    assert res["checks"]["render_max_abs"]["value"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_driver_runs_tiny_on_the_cpu_without_device_metrics(name,
                                                                 trace):
    cell = tiny(spec.Cell(spec.load_benchmark(), name))
    res = cpu_run(cell, trace=trace)
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["metrics"] == {}
    assert res["device"] == {"platform": "cpu", "count": 1}
    assert "breakdown" not in res
    if trace:
        assert set(res["cpu_readings"]) >= {"prologue_ms_per_frame",
                                            "level_ms_per_frame"}
    assert list(res)[-1] == "checks"
    assert list(res["checks"]) == ["render_max_abs", "match_far_share",
                                   "psnr_db"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit", "holds"}


def _raises_at(make, at):
    def made(*args):
        drv = make(*args)
        real = drv.unit

        def unit(k, keep=False, progress=None):
            if k == at:
                raise RuntimeError("injected")
            return real(k, keep, progress)

        drv.unit = unit
        return drv
    return made


def test_a_unit_that_raises_counts_as_failed_and_not_correct(monkeypatch):
    cell = tiny(spec.Cell(spec.load_benchmark(), "superres.1024.single"))
    mod = spec.driver_module(cell.mix["driver"])
    monkeypatch.setattr(mod, "make", _raises_at(mod.make, 1))
    res = cpu_run(cell, seconds=30.0)
    assert res["attempted"] == 2 and res["failed"] == 1
    assert res["correct"] is False


class _Timed(Driver):
    """A driver whose unit takes a known time and returns nothing to
    judge."""

    frames_per_unit = 3

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def warm(self):
        pass

    def unit(self, k, keep=False, progress=None):
        time.sleep(0.02)
        if k == self.fail_at:
            raise RuntimeError("injected")

    def keep(self, k, answer, rng):
        pass

    def kept(self):
        return []

    def release(self):
        pass


@pytest.mark.parametrize("fail_at", [None, 4])
def test_the_rate_counts_returned_frames_over_the_whole_window(
        monkeypatch, fail_at):
    cell = tiny(spec.Cell(spec.load_benchmark(), "superres.1024.single"))
    mod = spec.driver_module(cell.mix["driver"])
    monkeypatch.setattr(mod, "make", lambda *a: _Timed(fail_at))
    res = cpu_run(cell, seconds=0.2)
    rate = res["cpu_readings"]["frames_per_s"]["value"]
    if fail_at is None:
        frames = res["attempted"]
        assert res["failed"] == 0 and frames >= 3 * 8
        # The window runs to the end of its last unit: the rate divides
        # by at least the nominal seconds and at most one unit more.
        assert frames / 0.3 <= rate <= frames / 0.2
    else:
        # Four units returned before the fifth raised and ended the loop.
        assert res["attempted"] == 15 and res["failed"] == 3
        assert 12 / 0.2 <= rate <= 12 / 0.09
    assert res["correct"] is False  # nothing was judged


def test_the_k1_work_count_against_a_hand_count():
    from portbench import workcount as wc

    # One 128 x 128 frame against a 128 x 128 A, with the coarse pair:
    # per candidate 3 * 4 channels + 4 * 5 + 1 + 4 * 3 + 1 = 46 FLOP.
    assert wc.k1_flop_per_candidate(2, 2, 5, 3) == 46
    assert wc.k1_flop_per_candidate(2, 0, 5, 3) == 27
    flops, nbytes = wc.k1_sweep_work(128, 128, 128, 128, 1, True)
    assert flops == 128 * 128 * 36 * 46
    planes = 4 * (2 * 128 * 128 + 2 * 64 * 64)
    assert nbytes == 2 * planes + 24 * 128 * 128
    # Levels 256 and 128 run the tile path, 64 does not; 2 EM x 6 sweeps.
    shapes = wc.level_shapes((256, 256), (256, 256), 3)
    got = wc.k1_bound_s(shapes, 1, 2, 6)
    f256, b256 = wc.k1_sweep_work(256, 256, 256, 256, 1, True)
    assert got["sweeps"] == 24
    assert got["flops"] == 12 * (f256 + flops)
    want = 12 * (max(f256 / wc.PEAK_FP32_FLOPS, b256 / wc.PEAK_BYTES)
                 + max(flops / wc.PEAK_FP32_FLOPS, nbytes / wc.PEAK_BYTES))
    assert abs(got["bound_s"] - want) < 1e-15
    # Past 4 Mpx of A a level runs two more sweeps an EM step.
    big = wc.k1_bound_s([(2048, 4096, 2048, 4096)], 1, 2, 6)
    assert big["sweeps"] == 16


def test_k1_roofline_counts_from_the_cell_files_alone():
    """The reader's bound: the configuration's knobs, the reference's level
    count and the mix's side; nothing of the program."""
    from portbench import workcount as wc

    cell = spec.Cell(spec.load_benchmark(), "superres.1024.single")
    ctx = {"cell": cell, "traced": {
        "profiled_frames": 1,
        "trace": {"ops": {"void tile_sweep_kernel<2, float>(Args)": 2.0,
                          "void at::native::gather<3>()": 5.0}}}}
    read = spec.metric_reader("k1_roofline")
    shapes = [(1024 >> i,) * 4 for i in range(5)]
    want = wc.k1_bound_s(shapes, 1, 2, 6)["bound_s"]
    assert wc.k1_bound_s(shapes, 1, 2, 6)["sweeps"] == 4 * 12
    assert abs(read(ctx) - 100.0 * want * 1e3 / 2.0) < 1e-12
    # 3 levels once the configuration's min_size stops the pyramid.
    cell.config["synth"]["min_size"] = 256
    want3 = wc.k1_bound_s(shapes[:3], 1, 2, 6)["bound_s"]
    assert abs(read(ctx) - 100.0 * want3 * 1e3 / 2.0) < 1e-12
    ctx["traced"]["trace"]["ops"] = {"void at::native::gather<3>()": 5.0}
    assert read(ctx) is None


def test_only_the_judged_units_ask_for_their_fields(monkeypatch):
    """The window's reservoir draw comes before each unit; only the units
    it keeps ask the program for the fields, and the judge gets the last
    of them."""
    cell = tiny(spec.Cell(spec.load_benchmark(), "npr.8x1024.batch"))
    mod = spec.driver_module(cell.mix["driver"])
    make = mod.make
    calls = []

    def recording(*args):
        drv = make(*args)
        real = drv._run

        def run_job(a, ap, frames, cfg, **kw):
            calls.append(kw["return_nnf"])
            return real(a, ap, frames, cfg, **kw)

        drv._run = run_job
        return drv

    monkeypatch.setattr(mod, "make", recording)
    res = cpu_run(cell, seed=2**33 + 1, seconds=3.0)
    window = calls[1:]  # calls[0] is the warm-up
    assert res["correct"] is True
    assert len(window) >= 4 and window[0] is True
    assert calls[0] is False and sum(window) < len(window)


def test_a_mix_with_its_own_driver_and_metric_added_as_files_alone(
        tmp_path):
    """A driver file whose window records each unit's latency, a mix
    naming it, and a reader of a new end-to-end metric: found by name and
    run, with no file of the harness edited."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "drivers" / "paced_single_test.py").write_text(
        "from portbench.drivers.library_single import SingleImage\n"
        "class Paced(SingleImage):\n"
        "    def window(self, seconds, seed, sync):\n"
        "        rec = super().window(seconds, seed, sync)\n"
        "        rec['latency_s'] = list(rec['unit_s'])\n"
        "        return rec\n"
        "def make(config, mix, seed, device):\n"
        "    return Paced(config, mix, seed, device)\n")
    (pkg / "metrics" / "unit_max_ms.py").write_text(
        "def read(ctx):\n"
        "    lat = ctx['window'].get('latency_s')\n"
        "    return 1e3 * max(lat) if lat else None\n")
    (pkg / "mixes" / "paced.40.json").write_text(json.dumps(
        {"driver": "paced_single_test", "size": 40, "pool": 2}))
    bench = spec.load_benchmark()
    bench["workloads"].append({
        "name": "superres.40.paced", "config": "superres",
        "traffic": "paced.40", "chips": 1, "why": "added as files"})
    bench["end_to_end"].append({
        "name": "unit_max_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["superres.40.paced"]})
    assert spec.problems(bench, root=ROOT, pkg=pkg) == []
    cell = spec.Cell(bench, "superres.40.paced", pkg=pkg)
    cell.config["synth"]["levels"] = 2
    res = cpu_run(cell)
    assert res["correct"] is True
    assert res["cpu_readings"]["unit_max_ms"]["value"] > 0.0
    assert set(res["cpu_readings"]) == {"setup_s", "frames_per_s",
                                        "unit_max_ms"}


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["image_analogies_tpu_torch", "image_analogies_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["jax.numpy"]) == ["jax"]
    assert run.forbidden_modules(["image_analogies_tpu.models"]) == [
        "image_analogies_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_portbench_imports_jax_or_the_jax_package():
    bad = set(run.FORBIDDEN)
    for path in PKG.rglob("*.py"):
        assert not set(_imports(path)) & bad, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from portbench import run, spec\n"
        "cell = spec.Cell(spec.load_benchmark(), 'superres.1024.single')\n"
        "cell.mix.update(size=32, pool=1)\n"
        "cell.config['synth']['levels'] = 2\n"
        "res = run.run_cell(cell, 3, 0.01, True, device='cpu', t0=0.0)\n"
        "print(run.forbidden_modules(), res['correct'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "gen.py", "workcount.py", "trace_attr.py"):
        assert "image_analogies_tpu_torch" not in set(_imports(PKG / name))
    code = ("import sys\nimport portbench.reference, portbench.gen, "
            "portbench.workcount, portbench.trace_attr\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('image_analogies')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


# -- faults under the timed path: `correct` must come out false ----------


def _em_step_unchanged(cfg, level, has_coarse, lean=False, polish_iters=None):
    """An EM step that returns its incoming state unchanged."""
    def step(src_b, flt_b, src_b_c, flt_b_c, f_a, copy_a, nnf, draws,
             proj=None, a_planes=None, plan=None, temporal=None):
        return nnf, torch.zeros(flt_b.shape, dtype=torch.float32), flt_b
    return step


def _gather_altered(img, nnf):
    """The render with one pixel of its answer altered."""
    from image_analogies_tpu_torch.models import analogy

    out = analogy._gather_planes(img, nnf[..., 0], nnf[..., 1]).clone()
    out.view(-1)[0] += 0.05
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, name,
                                                      fault):
    from image_analogies_tpu_torch.models import analogy

    if fault == "state_unchanged":
        monkeypatch.setattr(analogy, "make_em_step", _em_step_unchanged)
    else:
        monkeypatch.setattr(analogy, "_gather_image", _gather_altered)
    cell = tiny(spec.Cell(spec.load_benchmark(), name))
    res = cpu_run(cell)
    assert res["correct"] is False
    assert not judge.holds(res["checks"]["render_max_abs"])


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    """A job that runs only the first half of its frames (their mean and
    spread taken over that half) and answers the second half with the
    first half's B' and fields.  Every frame of the kept job is judged,
    so no seed escapes."""
    cell = tiny(spec.Cell(spec.load_benchmark(), "npr.8x1024.batch"))
    mod = spec.driver_module(cell.mix["driver"])
    make = mod.make

    def halved(*args):
        drv = make(*args)
        real = drv._run

        def run_half(a, ap, frames, cfg, **kw):
            n = frames.shape[0] // 2
            got = real(a, ap, frames[:n], cfg, **kw)
            if not kw.get("return_nnf"):
                return torch.cat([got, got])
            out, nnf = got
            return torch.cat([out, out]), np.concatenate([nnf, nnf])

        drv._run = run_half
        return drv

    monkeypatch.setattr(mod, "make", halved)
    res = cpu_run(cell, seed=7)
    assert res["correct"] is False
    assert not judge.holds(res["checks"]["render_max_abs"])


def test_the_trace_reader_attributes_ops_and_labels_idle_gaps():
    """A hand-made Chrome trace: two launches under nested ranges, the
    device events after the ranges closed, one gap between them."""
    from portbench import trace_attr

    rng = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",  # noqa
                                 "name": name, "ts": ts, "dur": dur,
                                 "pid": 1, "tid": 1}
    launch = lambda c, ts: {"ph": "X", "cat": "cuda_runtime",  # noqa
                            "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                            "pid": 1, "tid": 1, "args": {"correlation": c}}
    kern = lambda c, name, ts, dur: {"ph": "X", "cat": "kernel",  # noqa
                                     "name": name, "ts": ts, "dur": dur,
                                     "pid": 0, "tid": 7,
                                     "args": {"correlation": c}}
    events = [
        rng("tlm_L0", 0, 100), rng("tlm_match", 10, 20),
        rng("tlm_render", 40, 50),
        launch(1, 12), launch(2, 45),
        kern(1, "void tile_sweep_kernel<2, float>(Args)", 50, 30),
        kern(2, "void at::native::gather<3>()", 95, 10),
    ]
    s = trace_attr.summarize(events)
    assert s["n_device"] == 2
    assert s["scoped_ops"] == {
        "tlm_L0/tlm_match/void tile_sweep_kernel<2, float>(Args)": 0.03,
        "tlm_L0/tlm_render/void at::native::gather<3>()": 0.01}
    assert s["busy_ms"] == 0.04 and s["span_ms"] == 0.055
    # The gap 80..95 us: at 87.5 tlm_render (40..90) is open in tlm_L0.
    assert s["idle_ms"] == {"tlm_L0/tlm_render": 0.015}
    assert trace_attr.top(s["scoped_ops"])[0] == [
        "tlm_L0/tlm_match/void tile_sweep_kernel", 0.03 / 1e3]
    assert trace_attr.top(s["idle_ms"]) == [["tlm_L0/tlm_render",
                                            0.015 / 1e3]]
    assert trace_attr.short_name("void k<1>(int)") == "void k"

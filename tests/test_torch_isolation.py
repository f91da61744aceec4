"""The port stands alone: it imports without JAX and names neither JAX nor
the JAX package in an import; a "cuda" run never carries on on the CPU;
and the kernel wrappers send CPU tensors to the plain versions without
counting a launch."""

import ast
import json
import pathlib
import re
import statistics
import subprocess
import sys

import pytest
import torch

import image_analogies_tpu_torch
from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch import kernels
from image_analogies_tpu_torch.kernels import nn_brute, patchmatch_tile as pt
from image_analogies_tpu_torch.kernels import polish_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(image_analogies_tpu_torch.__file__).resolve().parent


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['image_analogies_tpu'] = None; "
        "import image_analogies_tpu_torch as p; "
        "import image_analogies_tpu_torch.models, "
        "image_analogies_tpu_torch.kernels.patchmatch_tile, "
        "image_analogies_tpu_torch.kernels.nn_brute, "
        "image_analogies_tpu_torch.kernels.polish_stream, "
        "image_analogies_tpu_torch.parallel.spatial, "
        "image_analogies_tpu_torch.parallel.batch, "
        "image_analogies_tpu_torch.video.sequence, "
        "image_analogies_tpu_torch.utils.io, "
        "image_analogies_tpu_torch.utils.examples, "
        "image_analogies_tpu_torch.utils.native, "
        "image_analogies_tpu_torch.utils.profiling, "
        "image_analogies_tpu_torch.utils.progress, "
        "image_analogies_tpu_torch.models.ann, "
        "image_analogies_tpu_torch.telemetry.metrics, "
        "image_analogies_tpu_torch.telemetry.spans, "
        "image_analogies_tpu_torch.telemetry.flight, "
        "image_analogies_tpu_torch.telemetry.sentinel, "
        "image_analogies_tpu_torch.telemetry.slo, "
        "image_analogies_tpu_torch.telemetry.live, "
        "image_analogies_tpu_torch.telemetry.report, "
        "image_analogies_tpu_torch.utils.torch_trace, "
        "image_analogies_tpu_torch.utils.kernelbench, "
        "image_analogies_tpu_torch.runtime.faults, "
        "image_analogies_tpu_torch.runtime.supervisor, "
        "image_analogies_tpu_torch.telemetry.timeseries, "
        "image_analogies_tpu_torch.telemetry.anomaly, "
        "image_analogies_tpu_torch.serving, "
        "image_analogies_tpu_torch.serving.daemon, "
        "image_analogies_tpu_torch.cli; "
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None}; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_subpackage_is_checked():
    """The slab helpers' subpackage is among the files held to no JAX
    import below."""
    assert (PORT / "parallel" / "spatial.py") in set(PORT.rglob("*.py"))


@pytest.mark.parametrize("rel", ["parallel/batch.py", "video/sequence.py",
                                 "video/__init__.py", "utils/io.py"])
def test_batch_and_video_modules_are_checked(rel):
    """The batch runner, the video package and the image reader are
    among the files held to no JAX import below."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))


@pytest.mark.parametrize("rel", [
    "cli.py", "__main__.py", "telemetry/__init__.py", "telemetry/metrics.py",
    "telemetry/spans.py", "telemetry/flight.py", "runtime/__init__.py",
    "runtime/faults.py", "runtime/supervisor.py", "utils/native.py",
    "utils/profiling.py", "utils/progress.py", "models/ann.py",
])
def test_cli_telemetry_runtime_and_ann_modules_are_checked(rel):
    """The command line, the telemetry and runtime packages, the native
    loader, the profiling and progress utilities and the ann matcher are
    among the files held to no JAX import below."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))


@pytest.mark.parametrize("rel", [
    "telemetry/sentinel.py", "telemetry/slo.py", "telemetry/live.py",
    "telemetry/report.py", "utils/torch_trace.py", "utils/kernelbench.py",
])
def test_sentinel_live_report_and_bench_modules_are_checked(rel):
    """The run sentinel, the SLO engine, the live exporter, the report
    joiner, the trace reader and the K1 bench are among the files held to
    no JAX import below, and none names the repository's tools."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))
    assert "tools" not in set(_imported_roots(PORT / rel))


@pytest.mark.parametrize("rel", [
    "serving/__init__.py", "serving/queueing.py", "serving/accesslog.py",
    "serving/journal.py", "serving/excache.py", "serving/daemon.py",
    "telemetry/timeseries.py", "telemetry/anomaly.py",
])
def test_serving_modules_are_checked(rel):
    """The serving daemon's modules and the observatory's ring and
    watches are among the files held to no JAX import below, and none
    names the repository's tools."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))
    assert "tools" not in set(_imported_roots(PORT / rel))


def test_serving_imports_without_the_reference_package():
    """The serving package in a fresh process with both the JAX package
    and the tools directory unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['image_analogies_tpu'] = None; "
        "sys.modules['check_serve'] = None; "
        "from image_analogies_tpu_torch.serving import SynthDaemon; "
        "from image_analogies_tpu_torch.telemetry import anomaly, "
        "timeseries; "
        "assert not {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None} & {'jax', 'image_analogies_tpu'}; "
        "print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", [
    "serving/lattice.py", "serving/fleettrace.py", "serving/router.py",
    "serving/observatory.py", "telemetry/archive.py",
])
def test_fleet_modules_are_checked(rel):
    """The fleet's modules are among the files held to no JAX import
    below, and none names the repository's tools."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))
    assert "tools" not in set(_imported_roots(PORT / rel))


def test_fleet_imports_without_the_reference_package():
    """The fleet's modules in a fresh process with the JAX package and
    the validators unimportable; a router started and stopped there
    leaves CUDA uninitialised."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['image_analogies_tpu'] = None; "
        "[sys.modules.__setitem__(m, None) for m in ('check_router', "
        "'check_lattice', 'check_obs', 'check_fleet_trace', "
        "'check_archive', 'check_serve_persist')]; "
        "import torch; "
        "from image_analogies_tpu_torch.serving import lattice, "
        "fleettrace, observatory; "
        "from image_analogies_tpu_torch.serving.router import FleetRouter; "
        "from image_analogies_tpu_torch.telemetry import archive; "
        "from image_analogies_tpu_torch.telemetry.metrics import "
        "MetricsRegistry; "
        "FleetRouter(MetricsRegistry()).start().stop(); "
        "assert not torch.cuda.is_initialized(); "
        "assert not {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None} & {'jax', 'image_analogies_tpu'}; "
        "print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_PARALLEL = ("parallel/mesh.py", "parallel/comms.py", "parallel/plan2d.py",
             "parallel/sharded_a.py", "parallel/spatial.py")


@pytest.mark.parametrize("rel", _PARALLEL)
def test_multi_device_modules_are_checked(rel):
    """The multi-device runners' modules are among the files held to no
    JAX import below."""
    assert (PORT / rel) in set(PORT.rglob("*.py"))
    assert not {"jax", "image_analogies_tpu"} & set(
        _imported_roots(PORT / rel))


def test_multi_device_modules_import_without_the_reference_package():
    """The five `parallel/` modules in a fresh process with JAX and the
    JAX package unimportable; the planner runs and a one-rank gloo mesh
    is made there, leaving CUDA uninitialised."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['image_analogies_tpu'] = None; "
        "import torch; "
        "from image_analogies_tpu_torch.parallel import mesh, comms, "
        "plan2d, sharded_a, spatial; "
        "from image_analogies_tpu_torch.config import SynthConfig; "
        "p = plan2d.plan_mesh_shape(4, (256, 256), (512, 512), "
        "SynthConfig(device='cpu')); "
        "m = mesh.make_mesh(1, axis_names=('bands',), device_type='cpu'); "
        "assert mesh.axis_size(m, 'bands') == 1; "
        "torch.distributed.destroy_process_group(); "
        "assert not torch.cuda.is_initialized(); "
        "assert not {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None} & {'jax', 'image_analogies_tpu'}; "
        "print('ok', p.n_bands * p.n_slabs)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 4"


def test_banded_tile_wrapper_cpu_goes_plain_and_counts_nothing():
    pt.launches.reset()
    pt.launches_banded.reset()
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), False)
    h = w = ha = wa = 128
    geom = pt.tile_geometry(h, w, specs)
    img = [torch.rand(h, w) for _ in range(4)]
    bands = pt.prepare_a_planes(img[0], img[1], None, None, specs,
                                n_bands=2)
    b_planes = pt.prepare_b_planes(img[2], img[3], None, None, geom)
    cand = torch.zeros(geom.n_ty, geom.n_tx, pt.K_TOTAL, dtype=torch.int32)
    z = torch.zeros(geom.n_ty * 64, geom.n_tx * geom.tile_w,
                    dtype=torch.int32)
    d = torch.full(z.shape, float("inf"))
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    for planes, band in zip(bands, pt.band_bounds(ha, 2)):
        args = (planes, b_planes, cand, cand, cand + 1, z, z, d)
        pt.tile_sweep(*args, band=band, **kw)
        with pytest.raises(ValueError, match="CUDA tensor"):
            pt.tile_sweep_kernel(*args, band=band, **kw)
    assert pt.launches.count == 0 and pt.launches_banded.count == 0


def test_native_library_builds_apart_from_the_reference():
    """The port builds native/ann.cpp into its own directory, never the
    reference's native/build/."""
    from image_analogies_tpu_torch.utils import native

    assert native.BUILD_DIR.relative_to(ROOT).as_posix() == \
        "build/ia_torch_native"
    assert native.SRC.relative_to(ROOT).as_posix() == "native/ann.cpp"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "image_analogies_tpu"}, roots


def test_default_device_is_cuda_and_never_falls_back():
    assert SynthConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = torch.rand(32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_image_analogy(a, a, a, SynthConfig(levels=1))


def test_unknown_device_and_mode_rejected():
    with pytest.raises(ValueError):
        SynthConfig(device="tpu")
    with pytest.raises(ValueError):
        SynthConfig(pallas_mode="compiled")


def test_nn_wrapper_cpu_goes_plain_and_counts_nothing():
    nn_brute.launches.reset()
    f_b, f_a = torch.rand(20, 12), torch.rand(30, 12)
    idx = nn_brute.nn_argmin(f_b, f_a)
    assert idx.dtype == torch.int64 and idx.shape == (20,)
    assert nn_brute.launches.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_brute.nn_argmin_kernel(f_b, f_a, nn_brute.squared_norms(f_a))
    assert nn_brute.launches.count == 0


def test_tile_wrapper_cpu_goes_plain_and_counts_nothing():
    pt.launches.reset()
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), False)
    h = w = ha = wa = 128
    geom = pt.tile_geometry(h, w, specs)
    img = [torch.rand(h, w) for _ in range(4)]
    a_planes = pt.prepare_a_planes(img[0], img[1], None, None, specs)
    b_planes = pt.prepare_b_planes(img[2], img[3], None, None, geom)
    cand = torch.zeros(geom.n_ty, geom.n_tx, pt.K_TOTAL, dtype=torch.int32)
    z = torch.zeros(geom.n_ty * 64, geom.n_tx * geom.tile_w,
                    dtype=torch.int32)
    d = torch.full(z.shape, float("inf"))
    args = (a_planes, b_planes, cand, cand, cand + 1, z, z, d)
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    out = pt.tile_sweep(*args, **kw)
    assert torch.isfinite(out[2]).all()
    assert pt.launches.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt.tile_sweep_kernel(*args, **kw)
    assert pt.launches.count == 0


def test_tile_wrapper_frame_axis_cpu_goes_plain_and_counts_nothing():
    pt.launches.reset()
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), False)
    h = w = ha = wa = 128
    n_f = 3
    geom = pt.tile_geometry(h, w, specs)
    img = [torch.rand(h, w) for _ in range(2 + 2 * n_f)]
    a_planes = pt.prepare_a_planes(img[0], img[1], None, None, specs)
    b_planes = torch.stack([
        pt.prepare_b_planes(img[2 + 2 * i], img[3 + 2 * i], None, None, geom)
        for i in range(n_f)])
    cand = torch.zeros(n_f, geom.n_ty, geom.n_tx, pt.K_TOTAL,
                       dtype=torch.int32)
    z = torch.zeros(n_f, geom.n_ty * 64, geom.n_tx * geom.tile_w,
                    dtype=torch.int32)
    d = torch.full(z.shape, float("inf"))
    args = (a_planes, b_planes, cand, cand, cand + 1, z, z, d)
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    out = pt.tile_sweep(*args, **kw)
    assert out[2].shape == z.shape and torch.isfinite(out[2]).all()
    assert pt.launches.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt.tile_sweep_kernel(*args, **kw)
    with pytest.raises(ValueError, match="cand tables"):
        pt.tile_sweep(a_planes, b_planes, cand[:2], cand[:2], cand[:2] + 1,
                      z, z, d, **kw)
    assert pt.launches.count == 0


def test_batch_and_video_never_fall_back():
    from image_analogies_tpu_torch import synthesize_batch, synthesize_video

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = torch.rand(32, 32)
    for fn in (synthesize_batch, synthesize_video):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(a, a, a[None].repeat(2, 1, 1), SynthConfig(levels=1))


def test_tile_wrapper_int8_cpu_goes_plain_and_counts_nothing():
    pt.launches.reset()
    pt.launches_int8.reset()
    specs = pt.channel_specs(1, 1, SynthConfig(device="cpu"), False)
    h = w = ha = wa = 128
    geom = pt.tile_geometry(h, w, specs)
    img = [torch.rand(h, w) for _ in range(4)]
    a8 = pt.prepare_a_planes(img[0], img[1], None, None, specs,
                             cand_dtype="int8")
    assert a8.dtype == torch.int8
    b_planes = pt.prepare_b_planes(img[2], img[3], None, None, geom)
    cand = torch.zeros(geom.n_ty, geom.n_tx, pt.K_TOTAL, dtype=torch.int32)
    z = torch.zeros(geom.n_ty * 64, geom.n_tx * geom.tile_w,
                    dtype=torch.int32)
    args = (a8, b_planes, cand, cand, cand + 1, z, z,
            torch.full(z.shape, float("inf")))
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    out = pt.tile_sweep(*args, cand_dtype="int8", **kw)
    assert torch.isfinite(out[2]).all()
    assert pt.launches.count == pt.launches_int8.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt.tile_sweep_kernel(*args, **kw)
    assert pt.launches_int8.count == 0


def test_gather_wrapper_cpu_goes_plain_and_counts_nothing():
    polish_stream.launches.reset()
    table = polish_stream.prepare_polish_table(torch.rand(30, 68))
    idx = torch.tensor([[0, 29], [31, -1]])
    rows = polish_stream.gather_rows(table, idx)
    assert torch.equal(rows, table[[0, 29, 29, 0]])
    assert polish_stream.launches.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_stream.gather_rows_kernel(table, idx)
    assert polish_stream.launches.count == 0


def test_kernel_sources_and_build_dir():
    assert set(kernels.SOURCES) == {"tile_sweep", "nn_brute", "row_gather",
                                    "l2_probe", "pixel_cascade",
                                    "cand_tables"}
    assert "ia_gather_rows" in kernels.SOURCES["row_gather"]
    assert set(kernels.SOURCES["nn_brute"]) == {
        "ia_nn_split_tf32", "ia_nn_pad_bf16", "ia_nn_argmin",
        "ia_nn_argmin_bf16"}
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").exists()
        lib = kernels._lib_path(name)
        assert lib.parent == kernels.BUILD_DIR and len(lib.stem) > len(name)
    assert kernels.BUILD_DIR.relative_to(ROOT).as_posix() == \
        "build/ia_torch_kernels"
    gitignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in gitignore


def test_dispatch_rule():
    cfg = SynthConfig(device="cpu")
    assert kernels.tile_path(cfg)
    assert not kernels.tile_path(SynthConfig(device="cpu", pallas_mode="off"))
    assert kernels.on_cuda(torch.zeros(1, device="meta")) is False


@pytest.mark.parametrize("path", [
    PORT / "serving" / "ranks.py", PORT / "parallel" / "mesh.py",
    ROOT / "tests" / "torch_serve_workers.py",
], ids=["serving/ranks.py", "parallel/mesh.py", "torch_serve_workers.py"])
def test_multi_device_serving_modules_are_checked(path):
    """Multi-device serving's channel, its launcher and the tests'
    follower module import neither JAX nor the JAX package (the
    followers start from a fresh import of them)."""
    assert path.exists()
    assert not {"jax", "image_analogies_tpu"} & set(_imported_roots(path))


def test_multi_device_serving_runs_without_the_reference_package():
    """A serving world of one gloo rank in a fresh process with JAX and
    the JAX package unimportable: one dispatch through the channel,
    CUDA left uninitialised."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['image_analogies_tpu'] = None; "
        "import numpy as np, torch; torch.set_num_threads(1); "
        "from image_analogies_tpu_torch.config import SynthConfig; "
        "from image_analogies_tpu_torch.parallel.mesh import start_world; "
        "from image_analogies_tpu_torch.serving.ranks import ServingMesh, "
        "follow; "
        "a, ap, b = np.random.default_rng(0).random((3, 16, 16, 3))"
        ".astype(np.float32); "
        "m = ServingMesh(start_world(1, follow, device_type='cpu'), a, ap, "
        "device_type='cpu'); "
        "out = m.run(np.stack([b]), SynthConfig(device='cpu', levels=1, "
        "matcher='brute', em_iters=1)); "
        "assert m.close() == [] and out.shape == (1, 16, 16, 3); "
        "assert not torch.cuda.is_initialized(); "
        "assert not {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None} & {'jax', 'image_analogies_tpu'}; "
        "print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------ chip_smoke.py's checks
# The card check runs where JAX is absent: its obs-record check pools
# with the port's observatory, and the tools/check_*.py validators it
# runs stand alone.
_OBS_CHECK = """
import json, os, sys
root, record_path, out_dir = sys.argv[1:]
ref = os.path.join(root, "image_analogies_tpu")
sys.modules["jax"] = None
sys.modules["image_analogies_tpu"] = None
for d, _, files in os.walk(ref):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f[:-3]), root)
            name = rel.replace(os.sep, ".").removesuffix(".__init__")
            sys.modules[name] = None


def no_reference_file(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(ref + os.sep):
            raise RuntimeError("read " + path)


sys.addaudithook(no_reference_file)
sys.path.insert(0, root)
import chip_smoke

with open(record_path) as f:
    record = json.load(f)
try:
    print(chip_smoke.check_obs(record, out_dir))
except AssertionError as e:
    print("violations:", e)
assert not [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "image_analogies_tpu"))]
"""


@pytest.mark.parametrize("tamper", [None, "slo", "overhead"])
def test_chip_smoke_obs_check_without_the_reference(tamper, tmp_path,
                                                    monkeypatch):
    """chip_smoke's obs-record check in a fresh process where JAX, the
    JAX package and every module of it are unimportable and opening a
    file under image_analogies_tpu/ raises: the port-made record of a
    discovery file's targets (tests/test_torch_observatory.py) passes,
    and a record whose fleet SLO or overhead was altered fails."""
    from image_analogies_tpu_torch.serving import observatory as t_obs
    from image_analogies_tpu_torch.telemetry import metrics as t_metrics

    from test_torch_observatory import discovery_scrapes

    order, recs = discovery_scrapes(t_metrics)
    monkeypatch.setattr(t_obs, "scrape_replica",
                        lambda url, span_s=None, timeout=10.0: recs[url])
    record = t_obs.aggregate(order)
    record["observatory_overhead_frac"] = 0.001
    if tamper == "slo":
        record["fleet"]["slo"]["verdict"] = "tampered"
    elif tamper == "overhead":
        record["observatory_overhead_frac"] = 0.05
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(record))
    out = subprocess.run(
        [sys.executable, "-c", _OBS_CHECK, str(ROOT), str(path),
         str(tmp_path)], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    if tamper is None:
        assert line.startswith("check_obs: ") and " OK — 2 replicas" in line
        assert json.loads((tmp_path / "fleet_obs.json").read_text()) \
            == record
    else:
        assert line.startswith("violations: ")
        assert {"slo": "NOT bit-equal",
                "overhead": "observatory_overhead_frac 0.05"}[tamper] in line



@pytest.mark.parametrize("step_ms, cost_ms", [
    (0.0, 0.0), (30.0, 0.0), (-30.0, 0.0), (30.0, 25.0), (0.0, -25.0)])
def test_chip_smoke_obs_overhead_rounds(step_ms, cost_ms, monkeypatch):
    """chip_smoke's observatory overhead from ABBA rounds (off, on, on,
    off): a machine whose requests each take `step_ms` longer than the
    one before books nothing on the observatory, a cost on every on
    request shows in full over the median off wall, and a gain is
    floored at 0."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    off_ms, on_ms = [], []
    k = 0
    for _ in range(5):
        for walls, cost in ((off_ms, 0.0), (on_ms, cost_ms),
                            (on_ms, cost_ms), (off_ms, 0.0)):
            walls.append(1000.0 + step_ms * k + cost)
            k += 1
    frac, deltas = chip_smoke.abba_overhead(off_ms, on_ms)
    assert deltas == pytest.approx([cost_ms] * 5)
    assert frac == pytest.approx(max(0.0, cost_ms)
                                 / statistics.median(off_ms))

def _validator_path():
    """chip_smoke.py and the tools/check_*.py validators it runs (each
    named by a string constant of its own)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    tools = {m.group(1) for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value, str)
             for m in [re.fullmatch(r"(?:tools/)?(check_\w+\.py)",
                                    node.value)] if m}
    return [ROOT / "chip_smoke.py"] + [ROOT / "tools" / t
                                       for t in sorted(tools)]


def test_validator_path_is_the_tools_chip_smoke_runs():
    assert [p.name for p in _validator_path()] == [
        "chip_smoke.py", "check_archive.py", "check_fleet_trace.py",
        "check_lattice.py", "check_report.py", "check_router.py",
        "check_serve.py", "check_serve_persist.py"]


@pytest.mark.parametrize("path", _validator_path(), ids=lambda p: p.name)
def test_validator_path_names_no_reference(path):
    """No module of chip_smoke.py's validator path names the JAX package,
    except chip_smoke.py's `replaces` strings (the TPU kernel each
    kernel row stands for)."""
    for n, line in enumerate(path.read_text().splitlines(), 1):
        if re.search(r"\bimage_analogies_tpu\b", line):
            assert path.name == "chip_smoke.py" and re.search(
                r'"replaces": f?"image_analogies_tpu/kernels/', line), \
                f"{path.name}:{n}: {line.strip()}"

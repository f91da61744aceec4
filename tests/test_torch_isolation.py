"""The port stands alone: it imports without JAX and names neither JAX nor
the JAX package in an import; a "cuda" run never carries on on the CPU;
and the kernel wrappers send CPU tensors to the plain versions without
counting a launch."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import image_analogies_tpu_torch
from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch import kernels
from image_analogies_tpu_torch.kernels import nn_brute, patchmatch_tile as pt

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
        "image_analogies_tpu_torch.utils.examples; "
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None}; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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


def test_kernel_sources_and_build_dir():
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

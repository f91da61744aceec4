"""Hand-written Hopper kernels of the PyTorch port, and their build.

Every kernel here has a plain PyTorch version in the same module with the
same semantics.  Which one runs is decided by the tensor's device alone:

  - a CPU tensor runs the plain version;
  - a CUDA tensor launches the kernel, or the wrapper raises; no `try`
    gives way to the plain version when a build or launch fails.

`SynthConfig.pallas_mode` keeps its three values but chooses the
ALGORITHM, not the device (see `tile_path` below and config.py); only the
explicit "interpret" asks for K1's and K3's plain versions on a CUDA
tensor.

The CUDA sources (`csrc/*.cu`, plain C entry points) are compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` at first use, one `nvcc`
process per source, all started together, into `build/ia_torch_kernels/`
under the repository root.  Each library's file name carries the content
hash of its source, so an edited source is rebuilt and an unchanged one
is loaded as it is.  The libraries are loaded with `ctypes`; each C entry
returns `cudaGetLastError()` and the wrapper raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ia_torch_kernels"

# C entry point -> argtypes, per source.  Pointers and the stream are
# c_void_p (ctypes would otherwise pass a 32-bit int and cut them).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES: Dict[str, Dict[str, list]] = {
    "tile_sweep": {
        "ia_tile_sweep": [_P] * 12 + [_I] * 20 + [_F] + [_P],
    },
    "nn_brute": {
        "ia_nn_split_tf32": [_P] + [_I] * 4 + [_F] + [_P] * 3,
        "ia_nn_pad_bf16": [_P] + [_I] * 4 + [_F] + [_P] * 2,
        "ia_nn_argmin": [_P] * 7 + [_I] * 4 + [_P],
        "ia_nn_argmin_bf16": [_P] * 5 + [_I] * 4 + [_P],
    },
    "row_gather": {
        "ia_gather_rows": [_P] * 3 + [_L] + [_I] * 2 + [_P],
    },
    "l2_probe": {
        "ia_l2_read": [_P, _L, _I, _I, _P, _P],
    },
}


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the
    kernel, and nowhere else, so a run can show that its main path went
    through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def on_cuda(t: torch.Tensor) -> bool:
    """The one dispatch rule: CUDA tensors launch kernels."""
    return t.device.type == "cuda"


def tile_path(cfg) -> bool:
    """Whether PatchMatch runs the tile path (kernel K1 or its plain
    version) on tile-eligible levels: "auto" and "interpret" do, "off"
    runs the per-pixel sweeps everywhere."""
    return cfg.pallas_mode != "off"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels are "
        "built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_all() -> float:
    """Build (where the hash changed) and load every kernel library;
    returns the seconds it took.  Idempotent."""
    with _LOCK:
        t0 = time.perf_counter()
        todo = [n for n in SOURCES if n not in _LIBS]
        procs = []
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"),
            ]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SOURCES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def l2_read_rate(device, n_bytes: int = 32 << 20, passes: int = 20) -> float:
    """Bytes per second the card's L2 serves to 16-byte loads (the probe
    kernel of `csrc/l2_probe.cu`): a buffer of `n_bytes`, inside the
    50 MB L2, read `passes` times after a warming pass, timed by CUDA
    events; the best of 2, 4 and 8 blocks per SM, three readings each."""
    buf = torch.zeros(n_bytes // 4, dtype=torch.int32, device=device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    fn = library("l2_probe").ia_l2_read
    stream = stream_ptr(buf)
    best = 0.0
    for blocks in (2 * n_sm, 4 * n_sm, 8 * n_sm):
        check(fn(buf.data_ptr(), n_bytes, 1, blocks, sink.data_ptr(), stream),
              "ia_l2_read")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            check(fn(buf.data_ptr(), n_bytes, passes, blocks,
                     sink.data_ptr(), stream), "ia_l2_read")
            end.record()
            end.synchronize()
            best = max(best,
                       n_bytes * passes / (start.elapsed_time(end) * 1e-3))
    return best


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaGetLastError()` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype, shape, what: str) -> None:
    """The wrapper-side contract check before a pointer goes to C."""
    if not on_cuda(t):
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")

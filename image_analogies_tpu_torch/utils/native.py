"""ctypes loader and builder of the native kd-tree (`native/ann.cpp`).

The port reads the repository's C++ source as it is and builds its own
library with g++ (-O3, -fopenmp, a plain C interface) into
`build/ia_torch_native/`, under a name that carries the source's content
hash, so the two packages never write one `.so` and an edited source is
rebuilt.  A build is written to a process-private path and renamed into
place.  When g++ or OpenMP is missing the build fails once per process
with a warning and `load_ann()` returns None; callers then take the
exact search (`models/ann.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger("image_analogies_tpu_torch")

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "ann.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "ia_torch_native"

_lock = threading.Lock()
_cached: Optional[ctypes.CDLL] = None
_failed = False


def lib_path() -> Path:
    """The library's path for the source as it is now."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()
    return BUILD_DIR / f"libia_ann_{digest[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
           "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        log.warning("native ANN build failed: %s", detail.strip()[:500])
        if tmp.exists():
            tmp.unlink()
        return False


def load_ann() -> Optional[ctypes.CDLL]:
    """The kd-tree library with its argtypes set, built at first use, or
    None when it cannot be built or loaded."""
    global _cached, _failed
    with _lock:
        if _cached is not None:
            return _cached
        if _failed:
            return None
        out = lib_path()
        if not out.exists() and not _compile(out):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            log.warning("native ANN load failed: %s", e)
            _failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ann_build.argtypes = [f32p, ctypes.c_int, ctypes.c_int]
        lib.ann_build.restype = ctypes.c_void_p
        lib.ann_query.argtypes = [
            ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_float, i32p, f32p,
        ]
        lib.ann_query.restype = None
        lib.ann_free.argtypes = [ctypes.c_void_p]
        lib.ann_free.restype = None
        _cached = lib
        return lib


def ann_available() -> bool:
    return load_ann() is not None

"""Build, bind and count the hand-written CUDA kernels of csrc/.

The sources in ``csrc/*.cu`` (plain C entry points, no PyTorch headers)
are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library at first use, keyed by a hash of the sources and flags, under
``genrich_tpu_torch/_build/`` (git-ignored); the library is loaded with
ctypes.  Nothing is built or imported when this module is imported, so
CPU-only hosts (no nvcc, no card) can import every module of the
package.

``LAUNCHES`` counts, per kernel, the calls of its wrapper that
launched it on the card (the wrappers in ``ops/scan.py`` and
``ops/pipeline.py`` add one each time); a run reads the counts to show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# IEEE division and square root, no fused multiply-add contraction and
# no fast math: canon_value's /6 and /10 must round like the CPU's for
# coverage to be bitwise equal, and the p-value math stays as close to
# the plain float32 version as the card's libm allows.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
              "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"coverage_scan": 0, "tile_stats": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); "
                           "nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (cached by hash)."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"libgenrich_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + [str(f) for f in cus]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=secs, cached=False,
                      ptxas=r.stderr)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.coverage_scan_launch.argtypes = [
            p, i64, ctypes.c_int, p, f32, ctypes.c_int, p, p, p, p, p]
        lib.coverage_scan_launch.restype = ctypes.c_int
        lib.coverage_scan_tile.restype = i64
        lib.coverage_scan_tile.argtypes = []
        lib.tile_stats_launch.argtypes = [p, p, p, f32, f32, p, i64, p]
        lib.tile_stats_launch.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = library().kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

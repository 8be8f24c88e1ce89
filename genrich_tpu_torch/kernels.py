"""Build, bind and count the hand-written CUDA kernels of csrc/.

The sources in ``csrc/*.cu`` (plain C entry points, no PyTorch headers)
are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc -c`` per
source, all started together, and linked into one shared library at
first use, keyed by a hash of the sources and flags, under
``genrich_tpu_torch/_build/`` (git-ignored); the library is loaded with
ctypes.  Nothing is built or imported when this module is imported, so
CPU-only hosts (no nvcc, no card) can import every module of the
package.

``csrc/reference/*.cu`` holds earlier designs of the kernels, which the
card tests and chip_smoke.py hold the current ones to; they build into
a library of their own (``reference_library()``) that the port never
loads.  Those of K1-K3 include ``csrc/reference/pval_first.cuh``, a
frozen copy of the p-value header, not ``csrc/pval.cuh``.

``LAUNCHES`` counts, per kernel, the calls of its wrapper that
launched it on a card (the wrappers in ``ops/scan.py``,
``ops/pipeline.py``, ``ops/chisq.py`` and ``ops/peaks.py`` call
``count`` each time), and ``CARD_LAUNCHES`` the same per card index; a
run reads the counts to show that its main path went through the
kernels on every card it spans.  ``KERNELS_PER_CALL`` names the device
kernels that one such call runs (K2 runs two, the others one each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# IEEE division and square root, no fused multiply-add contraction and
# no fast math: canon_value's /6 and /10 must round like the CPU's for
# coverage to be bitwise equal, the p-value math stays as close to the
# plain float32 version as the card's libm allows, and peak_reduce's
# AUC adds each len * (stat - threshold) product after rounding it, as
# the exact engine does.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
              "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"coverage_scan": 0, "tile_stats": 0,
                            "fisher_combine": 0, "gap_join": 0,
                            "peak_reduce": 0}

# The device kernels that one counted call of each wrapper runs
# (chip_smoke.py checks them by CUDA graph capture on the paths' own
# calls; prof.py holds the profiler's kernel records to them).
KERNELS_PER_CALL: Dict[str, Tuple[str, ...]] = {
    "coverage_scan": ("coverage_scan_kernel",),
    "tile_stats": ("tile_stats_table_kernel", "tile_stats_kernel"),
    "fisher_combine": ("fisher_combine_kernel",),
    "gap_join": ("gap_join_kernel",),
    "peak_reduce": ("peak_reduce_kernel",)}


def is_kernel(name: str, ident: str) -> bool:
    """Whether a device kernel's ``name`` is the function ``ident``:
    mangled, as ``cuFuncGetName`` gives it (``_Z17tile_stats_kernelPKf...``),
    or demangled, as torch.profiler does (``tile_stats_kernel(float
    const*, ...)``)."""
    return f"{len(ident)}{ident}" in name or re.search(
        rf"(?<!\w){ident}(?!\w)", name) is not None


_lib: Optional[ctypes.CDLL] = None
_ref_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


CARD_LAUNCHES: Dict[int, Dict[str, int]] = {}


def count(name: str, device) -> None:
    """One launch of ``name``'s kernel on ``device`` (a CUDA
    ``torch.device``), counted in ``LAUNCHES`` and ``CARD_LAUNCHES``."""
    LAUNCHES[name] += 1
    card = CARD_LAUNCHES.setdefault(device.index,
                                    dict.fromkeys(LAUNCHES, 0))
    card[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CARD_LAUNCHES.clear()


def _sources(src_dir: Path):
    """The sources of a library and every header they may include."""
    cuhs = set(CSRC.glob("*.cuh")) | set(src_dir.glob("*.cuh"))
    return sorted(src_dir.glob("*.cu")), sorted(cuhs)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); "
                           "nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(src_dir: Path = CSRC, name: str = "genrich_kernels",
          info: Optional[Dict[str, object]] = None,
          flags: Tuple[str, ...] = ()) -> Path:
    """Compile ``src_dir/*.cu`` into one shared library (cached by
    hash), with ``flags`` added to ``NVCC_FLAGS``; ``info``
    (``BUILD_INFO`` by default) gets its path, seconds and ptxas
    report."""
    info = BUILD_INFO if info is None else info
    cus, cuhs = _sources(src_dir)
    nvcc_flags = NVCC_FLAGS + list(flags)
    h = hashlib.sha256(" ".join(nvcc_flags).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        info.update(path=str(so), seconds=0.0, cached=True)
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        procs = []
        for f in cus:
            cmd = [nvcc] + nvcc_flags + ["-I", str(CSRC), "-c", "-o",
                                         str(tmp / (f.stem + ".o")), str(f)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        ptxas = []
        failed = []
        for cmd, p in procs:
            _, err = p.communicate()
            ptxas.append(err)
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = tmp / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(out)] \
            + [str(tmp / (f.stem + ".o")) for f in cus]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stderr}")
        os.replace(out, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info.update(path=str(so), seconds=time.perf_counter() - t0,
                cached=False, ptxas="".join(ptxas))
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.coverage_scan_launch.argtypes = [
            p, i64, ctypes.c_int, p, f32, ctypes.c_int, p, p, p, p]
        lib.coverage_scan_launch.restype = ctypes.c_int
        lib.coverage_scan_scratch.restype = i64
        lib.coverage_scan_scratch.argtypes = [i64, ctypes.c_int]
        lib.tile_stats_launch.argtypes = [p, p, p, f32, f32, p, i64, p, p]
        lib.tile_stats_launch.restype = ctypes.c_int
        lib.tile_stats_scratch_bytes.restype = i64
        lib.tile_stats_scratch_bytes.argtypes = []
        lib.fisher_combine_launch.argtypes = [p, ctypes.c_int, i64, p, p]
        lib.fisher_combine_launch.restype = ctypes.c_int
        lib.peak_reduce_launch.argtypes = [p, p, p, p, p, p, p, p, i64,
                                           i64, f32, p, p, p, p, p, p, p]
        lib.peak_reduce_launch.restype = ctypes.c_int
        bind_gap_join(lib)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bind_gap_join(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the gap-join's entry points (csrc/gapjoin.cu) on ``lib``:
    the port's library, or a build of gapjoin.cu alone."""
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.gap_join_state_ints.argtypes = [i64]
    lib.gap_join_state_ints.restype = i64
    lib.gap_join_grid.argtypes = [i64]
    lib.gap_join_grid.restype = i64
    lib.gap_join_launch.argtypes = [p, p, p, p, i64, f32, i64, i64, p, p, p,
                                    p, p, p, p, p, p]
    lib.gap_join_launch.restype = ctypes.c_int
    return lib


def reference_library() -> ctypes.CDLL:
    """The earlier kernel designs of csrc/reference (built on first
    call); for the card tests and chip_smoke.py only."""
    global _ref_lib
    if _ref_lib is None:
        lib = ctypes.CDLL(str(build(CSRC / "reference",
                                    "genrich_kernels_reference", {})))
        p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.peak_reduce_warp_launch.argtypes = [
            p, p, p, p, p, p, p, p, i64, f32, p, p, p, p, p, p, p]
        lib.peak_reduce_warp_launch.restype = ctypes.c_int
        lib.coverage_scan_three_pass_launch.argtypes = [
            p, i64, ctypes.c_int, p, f32, ctypes.c_int, p, p, p, p, p]
        lib.coverage_scan_three_pass_launch.restype = ctypes.c_int
        lib.coverage_scan_three_pass_tile.restype = i64
        lib.coverage_scan_three_pass_tile.argtypes = []
        lib.tile_stats_first_launch.argtypes = [p, p, p, f32, f32, p, i64,
                                                p]
        lib.tile_stats_first_launch.restype = ctypes.c_int
        lib.fisher_combine_first_launch.argtypes = [p, ctypes.c_int, i64, p,
                                                    p]
        lib.fisher_combine_first_launch.restype = ctypes.c_int
        lib.gap_join_first_scratch.argtypes = [i64]
        lib.gap_join_first_scratch.restype = i64
        gap_join = [p, p, p, p, i64, f32, i64, i64, p, p, p, p, p, p, p, p]
        lib.gap_join_first_launch.argtypes = gap_join
        lib.gap_join_first_launch.restype = ctypes.c_int
        lib.gap_join_first_part.argtypes = [ctypes.c_int] + gap_join
        lib.gap_join_first_part.restype = ctypes.c_int
        _ref_lib = lib
    return _ref_lib


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


def aligned(t, nbytes: int):
    """``t`` itself if its data starts on an ``nbytes`` boundary (a
    kernel's vector loads need it), else an aligned copy."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()

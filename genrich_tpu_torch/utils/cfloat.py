"""C float32 semantics + printf-compatible formatting helpers.

The reference stores pileup/stat values as C ``float`` and prints them
with ``printf("%f", ...)`` (promotion to double, 6 decimals).  These
helpers reproduce that exactly so outputs compare byte-for-byte.
"""

from __future__ import annotations

import numpy as np

FLT_MAX = np.float32(3.4028234663852886e38)  # float.h FLT_MAX
SKIP = np.float32(-1.0)  # Genrich.h:27 sentinel for excluded regions
NOSCORE = np.float32(-FLT_MAX)  # Genrich.h:43 (-FLT_MAX)

# constants for the sd = 1.2*mu log-normal branch (Genrich.h:52-53)
LOGSQRT = 0.445999019652555  # log(sqrt(2.44))
SQRTLOG = 0.944456478248262  # sqrt(log(2.44))


def f32(x) -> np.float32:
    """Round a python/np number to float32 (one C float store)."""
    return np.float32(x)


def strtof(s: str) -> np.float32:
    """C strtof: parse to float32 directly (single rounding from decimal).

    Python ``float(s)`` rounds to float64; rounding that to float32 can
    double-round.  numpy.float32(str) parses directly to f32.
    """
    return np.float32(s)


_libm = None


def _get_libm():
    global _libm
    if _libm is None:
        import ctypes
        import ctypes.util
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.log10f.restype = ctypes.c_float
        lib.log10f.argtypes = [ctypes.c_float]
        _libm = lib
    return _libm


def log10f(x) -> np.float32:
    """C log10f via libm (numpy's float32 log10 can differ by 1 ulp)."""
    import ctypes
    return np.float32(_get_libm().log10f(
        ctypes.c_float(np.float32(x)).value))


def log10f_arr(x: np.ndarray) -> np.ndarray:
    """Elementwise C log10f over an array.

    This glibc's log10f is *not* correctly rounded (differs from
    float64-log10-then-round on ~5% of values), so matching the
    reference binary requires calling the real libm function per
    element.  The native ingest library batches the loop; the ctypes
    fallback covers builds without it.
    """
    from ..ingest.native import log10f_arr_native
    out = log10f_arr_native(x)
    if out is not None:
        return out
    import ctypes
    lib = _get_libm()
    f = lib.log10f
    cf = ctypes.c_float
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape, np.float32)
    flat = x.ravel()
    oflat = out.ravel()
    for i in range(flat.size):
        oflat[i] = f(cf(float(flat[i])).value)
    return out


def fmt_f(x) -> str:
    """printf("%f", (double)x) — 6 decimals, C rounding."""
    return f"{float(x):.6f}"


def fmt_prec(x, prec: int) -> str:
    """printf("%.<prec>f", (double)x)."""
    return f"{float(x):.{prec}f}"


def fmt_ld(x: int) -> str:
    """Render a uint64 through C's %ld (reinterpret as int64)."""
    x &= (1 << 64) - 1
    return str(x - (1 << 64) if x >= (1 << 63) else x)

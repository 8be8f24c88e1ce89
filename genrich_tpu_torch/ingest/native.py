"""ctypes bindings for the port's native C++ ingest library.

Wraps the library built from ``genrich_tpu_torch/native/ingest.cpp``
(SAM/BAM parsing, pair assembly, multimapper selection, PCR dedup,
interval generation — the byte-level host pipeline — plus the exact
engine's float32 peak caller, the ``-P`` log reader, the ``-f``/``-k``
row writers and a few numeric helpers).  The library produces
per-chromosome event arrays and counters identical to the pure-Python
ingest; tests assert equality.

Which library loads: always the one built from the port's own sources.
At first use ``ensure_native()`` builds ``native/ingest.cpp`` with the
port's ``native/Makefile`` (``-march=x86-64-v3`` and libdeflate, each
where the host has it) into the git-ignored
``genrich_tpu_torch/_build/``, keyed by a hash of the two files, and
loads that; a later process finds it there, and builds it anew if it
does not load (a tree copied from another host).  Concurrent first
uses (test workers, ranks) build once: one process holds an ``fcntl``
lock on the hash's lock file while it builds, and the others wait for
it and load its result.  Every entry point below goes through
``ensure_native()``; the Python versions run only after a build that
failed, which is then not retried in the process.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import GenrichError
from ..kernels import BUILD_DIR
from ..params import Params

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"

_lib = None
# the loaded library's build info ("path", "hash", "seconds", "cached",
# "libdeflate"), or {"error": why} after a build or load that failed
INFO: Dict[str, object] = {}


def source_hash() -> str:
    """The first 16 hex digits of the sha256 of the port's
    ``ingest.cpp`` and ``Makefile``: the built library's name."""
    h = hashlib.sha256()
    for name in ("ingest.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_native(build_dir, stale: Optional[int] = None
                 ) -> Dict[str, object]:
    """Build the ingest library into ``build_dir`` (cached by hash).

    ``stale`` is the inode of a cached library that did not load here
    (one built on another host): it is built anew unless another
    process has replaced it meanwhile.  Returns {"path", "hash",
    "seconds", "cached", "libdeflate"} (``cached`` when another process
    or an earlier run built it); raises RuntimeError if ``make`` fails.
    """
    digest = source_hash()
    build_dir = Path(build_dir)
    so = build_dir / f"libgenrich_ingest_{digest}.so"
    stamp = so.with_suffix(".flags")

    def cached():
        return {"path": str(so), "hash": digest, "seconds": 0.0,
                "cached": True, "libdeflate": stamp.exists()
                and "-DUSE_LIBDEFLATE" in stamp.read_text()}

    def usable():
        try:
            return so.stat().st_ino != stale
        except FileNotFoundError:
            return False

    if usable():
        return cached()
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when lock closes
        if usable():                       # built while this one waited
            return cached()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        os.unlink(tmp)                     # make builds a missing target
        t0 = time.perf_counter()
        r = subprocess.run(["make", "-C", str(NATIVE_DIR), f"TARGET={tmp}"],
                           capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if r.returncode != 0 or not os.path.exists(tmp):
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"make of {NATIVE_DIR / 'ingest.cpp'} failed "
                               f"({r.returncode}): {r.stderr.strip()[-500:]}")
        stamp.write_text(r.stdout)
        os.replace(tmp, so)
    return {"path": str(so), "hash": digest, "seconds": secs,
            "cached": False, "libdeflate": "-DUSE_LIBDEFLATE" in r.stdout}


def ensure_native() -> Dict[str, object]:
    """Build (at first use) and load the port's library.

    Returns ``INFO``; raises RuntimeError when the build or the load
    fails, and again on every later call in this process without
    building anew.
    """
    global _lib
    if _lib is None and "error" not in INFO:
        try:
            info = build_native(BUILD_DIR)
            try:
                lib = ctypes.CDLL(info["path"])
            except OSError as e:
                if not info["cached"]:
                    raise
                info = dict(build_native(BUILD_DIR, os.stat(
                    info["path"]).st_ino), stale_error=str(e))
                lib = ctypes.CDLL(info["path"])
            _lib = _bind(lib)
            INFO.update(info)
        except (OSError, RuntimeError) as e:
            INFO["error"] = str(e)
    if "error" in INFO:
        raise RuntimeError(INFO["error"])
    return INFO


def available() -> bool:
    """True if the native library loads (building it at first use)."""
    try:
        ensure_native()
        return True
    except RuntimeError:
        return False


def _load():
    ensure_native()
    return _lib


def _bind(lib):
    lib.gi_create.restype = ctypes.c_void_p
    lib.gi_error_msg.restype = ctypes.c_char_p
    lib.gi_error_msg.argtypes = [ctypes.c_void_p]
    lib.gi_error_code.restype = ctypes.c_int
    lib.gi_error_code.argtypes = [ctypes.c_void_p]
    lib.gi_destroy.argtypes = [ctypes.c_void_p]
    lib.gi_add_xchr.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gi_add_xbed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_uint32]
    lib.gi_set_options.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.gi_reset_save.argtypes = [ctypes.c_void_p]
    lib.gi_parse.restype = ctypes.c_int64
    lib.gi_parse.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int]
    lib.gi_chrom_count.restype = ctypes.c_int
    lib.gi_chrom_count.argtypes = [ctypes.c_void_p]
    lib.gi_chrom_name.restype = ctypes.c_char_p
    lib.gi_chrom_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_len.restype = ctypes.c_uint32
    lib.gi_chrom_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_skip.restype = ctypes.c_int
    lib.gi_chrom_skip.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_save.restype = ctypes.c_int
    lib.gi_chrom_save.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_bed_len.restype = ctypes.c_int
    lib.gi_chrom_bed_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_bed.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint32)]
    lib.gi_event_count.restype = ctypes.c_int64
    lib.gi_event_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_events.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int32)]
    lib.gi_counters.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_double)]
    return lib


def call_peaks_native(stat, pval, qval, ends, min_pq, min_auc,
                      min_len: int, max_gap: int):
    """Native exact-f32 peak caller (gi_call_peaks), or None if the
    library is absent.  Returns parallel numpy arrays
    (start, end, auc, summit_pval, summit_qval, summit_pos)."""
    try:
        lib = _load()
    except Exception:
        return None
    if not hasattr(lib, "_peaks_ready"):
        pf = ctypes.POINTER(ctypes.c_float)
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.gi_call_peaks.restype = ctypes.c_int64
        lib.gi_call_peaks.argtypes = [
            pf, pf, pf, p64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
            p64, p64, pf, pf, pf, p64, ctypes.c_int64]
        lib._peaks_ready = True
    stat = np.ascontiguousarray(stat, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    ends = np.ascontiguousarray(ends, np.int64)
    n = len(stat)
    sig = stat > np.float32(min_pq)
    cap = int(np.count_nonzero(sig[1:] & ~sig[:-1])
              + (1 if n and sig[0] else 0))
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    if cap == 0:
        z = np.zeros(0, np.float32)
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), z, z,
                z, np.zeros(0, np.int64))
    o_start = np.empty(cap, np.int64)
    o_end = np.empty(cap, np.int64)
    o_auc = np.empty(cap, np.float32)
    o_spv = np.empty(cap, np.float32)
    o_sqv = np.empty(cap, np.float32)
    o_spos = np.empty(cap, np.int64)
    qarr = (np.ascontiguousarray(qval, np.float32)
            if qval is not None else None)   # keep the buffer alive
    qptr = qarr.ctypes.data_as(pf) if qarr is not None else None
    got = lib.gi_call_peaks(
        stat.ctypes.data_as(pf), pval.ctypes.data_as(pf), qptr,
        ends.ctypes.data_as(p64), n, np.float32(min_pq),
        np.float32(min_auc), int(min_len), int(max_gap),
        o_start.ctypes.data_as(p64), o_end.ctypes.data_as(p64),
        o_auc.ctypes.data_as(pf), o_spv.ctypes.data_as(pf),
        o_sqv.ctypes.data_as(pf), o_spos.ctypes.data_as(p64),
        cap)
    assert got <= cap, (got, cap)
    return (o_start[:got], o_end[:got], o_auc[:got], o_spv[:got],
            o_sqv[:got], o_spos[:got])


def call_peaks_log_native(path: str, idx_p: int, idx_q: int,
                          use_q: bool, min_pq, min_auc,
                          min_len: int, max_gap: int,
                          genome_opt: bool):
    """Native -P fast path (gi_call_peaks_log), or None when the
    library is absent or the log needs the Python state machine
    (anomalous rows, post-hoc exclusions are gated by the caller).

    Returns (names, sec, start, end, auc, spv, sqv, spos,
    genome_len, peak_bp)."""
    try:
        lib = _load()
    except Exception:
        return None
    if not hasattr(lib, "_log_ready"):
        pf = ctypes.POINTER(ctypes.c_float)
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.gi_call_peaks_log.restype = ctypes.c_int64
        lib.gi_call_peaks_log.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.gi_log_section_count.restype = ctypes.c_int32
        lib.gi_log_section_name.restype = ctypes.c_char_p
        lib.gi_log_section_name.argtypes = [ctypes.c_int32]
        lib.gi_log_peaks_fetch.argtypes = [
            p32, p64, p64, pf, pf, pf, p64, p64, p64]
        lib._log_ready = True
    got = lib.gi_call_peaks_log(
        path.encode(), idx_p, idx_q, int(use_q),
        np.float32(min_pq), np.float32(min_auc), int(min_len),
        int(max_gap), int(genome_opt))
    if got < 0:
        return None
    n = int(got)
    sec = np.empty(max(n, 1), np.int32)
    start = np.empty(max(n, 1), np.int64)
    end = np.empty(max(n, 1), np.int64)
    auc = np.empty(max(n, 1), np.float32)
    spv = np.empty(max(n, 1), np.float32)
    sqv = np.empty(max(n, 1), np.float32)
    spos = np.empty(max(n, 1), np.int64)
    glen = ctypes.c_int64()
    pbp = ctypes.c_int64()
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.gi_log_peaks_fetch(
        sec.ctypes.data_as(p32), start.ctypes.data_as(p64),
        end.ctypes.data_as(p64), auc.ctypes.data_as(pf),
        spv.ctypes.data_as(pf), sqv.ctypes.data_as(pf),
        spos.ctypes.data_as(p64), ctypes.byref(glen),
        ctypes.byref(pbp))
    names = [lib.gi_log_section_name(i).decode()
             for i in range(lib.gi_log_section_count())]
    return (names, sec[:n], start[:n], end[:n], auc[:n], spv[:n],
            sqv[:n], spos[:n], int(glen.value), int(pbp.value))


def _rowlog_lib():
    try:
        lib = _load()
    except Exception:
        return None
    if not hasattr(lib, "_rows_ready"):
        pf = ctypes.POINTER(ctypes.c_float)
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.gi_append_text.restype = ctypes.c_int64
        lib.gi_append_text.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_char_p,
                                       ctypes.c_int64]
        lib.gi_write_log_rows.restype = ctypes.c_int64
        lib.gi_write_log_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            p64, p64, pf, pf, pf, pf, pu8, ctypes.c_int64]
        lib.gi_write_pile_rows.restype = ctypes.c_int64
        lib.gi_write_pile_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            p64, p64, pf, pf, pf, ctypes.c_int64]
        lib._rows_ready = True
    return lib


def append_text(path: str, gz: bool, text: str) -> bool:
    lib = _rowlog_lib()
    if lib is None:
        return False
    data = text.encode()
    return lib.gi_append_text(path.encode(), int(gz), data,
                              len(data)) == 0


def write_log_rows(path: str, gz: bool, name: str, starts, ends,
                   expt, ctrl, pval, qval, sig) -> bool:
    """Bulk -f rows (printInterval formats); False if lib absent."""
    lib = _rowlog_lib()
    if lib is None:
        return False
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    expt = np.ascontiguousarray(expt, np.float32)
    ctrl = np.ascontiguousarray(ctrl, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    qarr = (np.ascontiguousarray(qval, np.float32)
            if qval is not None else None)
    sarr = (np.ascontiguousarray(sig, np.uint8)
            if sig is not None else None)
    return lib.gi_write_log_rows(
        path.encode(), int(gz), name.encode(),
        starts.ctypes.data_as(p64), ends.ctypes.data_as(p64),
        expt.ctypes.data_as(pf), ctrl.ctypes.data_as(pf),
        pval.ctypes.data_as(pf),
        qarr.ctypes.data_as(pf) if qarr is not None else None,
        sarr.ctypes.data_as(pu8) if sarr is not None else None,
        len(starts)) == 0


def write_pile_rows(path: str, gz: bool, name: str, starts, ends,
                    expt, ctrl, pval) -> bool:
    """Bulk -k rows (printPile formats); False if lib absent."""
    lib = _rowlog_lib()
    if lib is None:
        return False
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    expt = np.ascontiguousarray(expt, np.float32)
    ctrl = np.ascontiguousarray(ctrl, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    return lib.gi_write_pile_rows(
        path.encode(), int(gz), name.encode(),
        starts.ctypes.data_as(p64), ends.ctypes.data_as(p64),
        expt.ctypes.data_as(pf), ctrl.ctypes.data_as(pf),
        pval.ctypes.data_as(pf), len(starts)) == 0


def breakpoints(start, end, count):
    """Native sorted nonzero-entry positions + canonical f32 values.

    Returns (upos int64, vals float32), or None if lib absent.
    Identical integer/float32 math to engine.pileup._nonzero_entries
    + canon_value_f32 (getVal, Genrich.c:1902-1907).
    """
    import numpy as np
    try:
        lib = _load()
    except Exception:
        return None
    if not hasattr(lib, "_bp_ready"):
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        pf = ctypes.POINTER(ctypes.c_float)
        lib.gi_breakpoints_arrays.restype = ctypes.c_int64
        lib.gi_breakpoints_arrays.argtypes = [p64, p64, p32,
                                              ctypes.c_int64]
        lib.gi_breakpoints_fetch.argtypes = [ctypes.c_void_p, p64, pf]
        lib._bp_ready = True
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    c = np.ascontiguousarray(count, np.int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pf = ctypes.POINTER(ctypes.c_float)
    n = lib.gi_breakpoints_arrays(s.ctypes.data_as(p64),
                                  e.ctypes.data_as(p64),
                                  c.ctypes.data_as(p32), len(s))
    upos = np.empty(n, np.int64)
    vals = np.empty(n, np.float32)
    lib.gi_breakpoints_fetch(None, upos.ctypes.data_as(p64),
                             vals.ctypes.data_as(pf))
    return upos, vals


def exact_sum_f32(terms) -> Optional[float]:
    """Sequential double += float reduction in C; None if lib absent."""
    import numpy as np
    try:
        lib = _load()
    except Exception:
        return None
    if not hasattr(lib, "_sum_ready"):
        lib.gi_exact_sum_f32.restype = ctypes.c_double
        lib.gi_exact_sum_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib._sum_ready = True
    t = np.ascontiguousarray(terms, np.float32)
    return lib.gi_exact_sum_f32(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(t))


def pair_index_tab(keys, uk, ends):
    """Fused distinct-pair row index + per-pair bp totals in C.

    ``keys`` are per-RLE-row packed (expt, ctrl) u64s, ``uk`` their
    sorted distinct table (np.unique(keys)), ``ends`` the int64 row
    end coordinates.  Returns (idx uint32, bp float64[d]) with
    uk[idx] == keys and bp[j] the summed interval length of pair j —
    the savePval row mapping plus the hashPval BH histogram terms
    (Genrich.c:1720-1794, 300-327) in one pass.  None if the library
    is absent or a key is missing from uk (caller falls back to
    numpy's searchsorted/bincount).
    """
    import numpy as np
    try:
        lib = _load()
        fn = lib.gi_pair_index_tab   # a stale library lacks the symbol
    except Exception:
        return None
    if not hasattr(lib, "_pit_ready"):
        pu64 = ctypes.POINTER(ctypes.c_uint64)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            pu64, ctypes.c_int64, pu64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_double)]
        lib._pit_ready = True
    k = np.ascontiguousarray(keys, np.uint64)
    u = np.ascontiguousarray(uk, np.uint64)
    e = np.ascontiguousarray(ends, np.int64)
    idx = np.empty(len(k), np.uint32)
    bp = np.empty(len(u), np.float64)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    rc = fn(
        k.ctypes.data_as(pu64), len(k), u.ctypes.data_as(pu64),
        len(u), e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        bp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return idx, bp


def log10f_arr_native(x) -> Optional["np.ndarray"]:
    """Elementwise libm log10f in C; None if lib absent."""
    import numpy as np
    try:
        lib = _load()
    except Exception:
        return None
    # its own flag: call_peaks_log_native sets "_log_ready" for
    # gi_call_peaks_log's argtypes
    if not hasattr(lib, "_log10_ready"):
        lib.gi_log10f.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64]
        lib._log10_ready = True
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty(xin.shape, np.float32)
    lib.gi_log10f(
        xin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        xin.size)
    return out


_COUNTER_FIELDS = ("count", "unmapped", "paired", "single", "orphan",
                   "paired_pr", "single_pr", "supp", "skipped",
                   "low_mapq", "sec_pair", "sec_single", "count_pr",
                   "dups_pr", "count_dc", "dups_dc", "count_sn",
                   "dups_sn", "err_count")


class NativeIngest:
    """A persistent native parsing context (chrom registry survives
    across files, as in the reference's runProgram loop)."""

    def __init__(self, p: Params,
                 xbed: List[Tuple[str, int, int]]):
        self._lib = _load()
        self._h = self._lib.gi_create()
        for name in p.xchr_list:
            self._lib.gi_add_xchr(self._h, name.encode())
        for (name, p0, p1) in xbed:
            self._lib.gi_add_xbed(self._h, name.encode(), p0, p1)
        self._lib.gi_set_options(
            self._h, p.single_opt, p.extend_opt, p.extend,
            p.avg_ext_opt, p.atac_opt, p.atac_adj, p.atac_len5,
            p.atac_len3, p.min_mapq, float(p.as_diff), p.dups_opt,
            p.sort_opt, p.verbose)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gi_destroy(self._h)
            self._h = None

    def reset_save(self) -> None:
        self._lib.gi_reset_save(self._h)

    def parse(self, path: str, ctrl: bool, sample: int,
              bed_path: Optional[str], dups_path: Optional[str],
              gz_out: bool) -> int:
        n = self._lib.gi_parse(
            self._h, path.encode(), 0, int(ctrl), sample,
            (bed_path or "").encode(), int(gz_out),
            (dups_path or "").encode(), int(gz_out))
        if n < 0:
            code = self._lib.gi_error_code(self._h)
            msg = self._lib.gi_error_msg(self._h).decode()
            raise GenrichError(msg, code)
        return n

    def chroms(self):
        """[(name, length, skip, save, bed_list)] in registry order."""
        out = []
        for i in range(self._lib.gi_chrom_count(self._h)):
            nbed = self._lib.gi_chrom_bed_len(self._h, i)
            bed = (ctypes.c_uint32 * max(nbed, 1))()
            if nbed:
                self._lib.gi_chrom_bed(self._h, i, bed)
            out.append((self._lib.gi_chrom_name(self._h, i).decode(),
                        self._lib.gi_chrom_len(self._h, i),
                        bool(self._lib.gi_chrom_skip(self._h, i)),
                        bool(self._lib.gi_chrom_save(self._h, i)),
                        list(bed[:nbed])))
        return out

    def events(self, chrom_index: int):
        n = self._lib.gi_event_count(self._h, chrom_index)
        if n == 0:
            return None
        start = np.empty(n, np.int64)
        end = np.empty(n, np.int64)
        count = np.empty(n, np.int32)
        self._lib.gi_events(
            self._h, chrom_index,
            start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return start, end, count

    def counters(self):
        u = (ctypes.c_uint64 * len(_COUNTER_FIELDS))()
        t = ctypes.c_double()
        self._lib.gi_counters(self._h, u, ctypes.byref(t))
        vals = dict(zip(_COUNTER_FIELDS, u))
        vals["total_len"] = t.value
        return vals

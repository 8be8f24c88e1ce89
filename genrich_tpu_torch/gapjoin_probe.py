"""Timing probes of kernel K5 (the gap-join) on one card.

    python -m genrich_tpu_torch.gapjoin_probe split [--out FILE]
    python -m genrich_tpu_torch.gapjoin_probe sweep [--out FILE]
    python -m genrich_tpu_torch.gapjoin_probe trace [--out FILE]

``split`` takes K5's first design (``csrc/reference/gapjoin_first.cu``:
a memset, the scan kernel and a finish kernel per call) on
``testing.gap_join_rows`` at 337,000 rows (one call of the sharded main
path) and 2^23 rows, and splits a call's device time: each operation
alone, the three with a CUDA event between each two, the call whole,
two events with nothing between, and torch.profiler's device time per
operation over 20 calls (what is left of the call is the gaps between
them). It also times whole calls at a ladder of sizes, for a fit of
time against rows.

``sweep`` builds ``csrc/gapjoin.cu`` once for each set of constants of
``SWEEP`` (``-DGJ_THREADS``, ``-DGJ_ITEMS`` ...), and times each build's
call against the first design's, every output held bitwise to the
plain version, at the rows and slots of ``SWEEP_ROWS``.

``trace`` builds it with ``-DGJ_TRACE``, whose kernel stamps
%globaltimer at each phase of each block and tile, and prints where a
call's time goes at the rows and slots of ``SWEEP_ROWS``: medians and
maxima of each phase over the tiles, the span, the last block's slots.

Each prints one JSON line per measurement and writes all of them to
``--out`` (default ``.bench_cache/gapjoin_<mode>.json``, git-ignored).
Times are the device's (the card spins ahead of the first event), in
ms.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import kernels, testing

SPLIT_ROWS = (337_000, 1 << 23)
LADDER = (1 << 16, 1 << 18, 337_000, 1 << 20, 1_110_000, 1 << 21, 1 << 22,
          1 << 23)
# gapjoin.cu's constants of each build the sweep times: threads a block,
# rows a thread, ring stages, and the blocks an SM must hold
# (__launch_bounds__; by default as many as the ring's shared memory lets)
SWEEP = (dict(THREADS=256, ITEMS=16, STAGES=2),
         dict(THREADS=256, ITEMS=16, STAGES=1, MIN_BLOCKS=3),
         dict(THREADS=256, ITEMS=16, STAGES=1, MIN_BLOCKS=4),
         dict(THREADS=256, ITEMS=8, STAGES=2, MIN_BLOCKS=3),
         dict(THREADS=512, ITEMS=8, STAGES=1, MIN_BLOCKS=2))
# (rows, K slots) of each timing
SWEEP_ROWS = ((337_000, 4096), (337_000, 16), (1_110_000, 4096),
              (1 << 23, 4096))
GAP = 100


def _rows(m):
    """Rows for the gap-join at the density of chip_smoke's synthetic
    phase (one peak region per 21 rows, SKIP, dead and zero-length
    rows), on the card."""
    import torch
    rows = testing.gap_join_rows(np.random.RandomState(3), m, GAP,
                                 max(1, m // 21), dead_tail=min(5000, m // 8))
    return [torch.from_numpy(a).cuda() for a in rows] + [2.0, GAP, 4096]


def _same(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _split_one(m, reps=50):
    import torch
    args = _rows(m)
    whole = testing.gap_join_first_design(*args)
    plain = _plain(args)
    if not _same(whole, plain):
        raise AssertionError(f"first design differs from plain at {m} rows")
    _, bufs = testing.gap_join_first_design(*args, part=0)

    def part(p):
        return lambda: testing.gap_join_first_design(*args, part=p,
                                                     bufs=bufs)
    for p in (0, 1, 2):
        part(p)()
    deltas = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        for p in (0, 1, 2):
            part(p)()
            ev[p + 1].record()
        ev[3].synchronize()
        deltas.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                      + [ev[0].elapsed_time(ev[3])])
    med = np.median(np.array(deltas), axis=0).tolist()
    res = {"rows": m, "tiles": -(-m // 1024), "peaks": int(whole.n),
           "call_ms": testing.median_ms(
               lambda: testing.gap_join_first_design(*args), reps),
           "call_host_ms": testing.median_ms(
               lambda: testing.gap_join_first_design(*args), reps,
               busy=False),
           "interleaved_ms": dict(zip(("memset", "scan", "finish", "all"),
                                      med)),
           "memset_alone_ms": testing.median_ms(part(0), reps),
           "finish_alone_ms": testing.median_ms(part(2), reps),
           "event_pair_ms": testing.median_ms(lambda: None, reps)}
    res["profiler_ms"] = _profile(lambda: testing.gap_join_first_design(
        *args), 20)
    return res


def _plain(args):
    from .ops import peaks
    cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
    want = peaks.peak_candidates_plain(*cpu)
    return type(want)(*(t.cuda() for t in want))


def _profile(fn, calls):
    """Device time per operation name, per call, from torch.profiler over
    ``calls`` calls (with each name's record count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key[:60]] = {"ms_per_call": us / 1e3 / calls,
                           "records": e.count}
    return out


def split():
    lines = []
    for m in SPLIT_ROWS:
        lines.append(dict(mode="split", **_split_one(m)))
        print(json.dumps(lines[-1]), flush=True)
    for m in LADDER:
        args = _rows(m)
        lines.append({"mode": "ladder", "rows": m,
                      "call_ms": testing.median_ms(
                          lambda: testing.gap_join_first_design(*args), 30)})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _variant(consts):
    """``csrc/gapjoin.cu`` alone, built with these constants, loaded."""
    import ctypes
    import shutil
    import tempfile
    from pathlib import Path
    src = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
    shutil.copy(kernels.CSRC / "gapjoin.cu", src / "gapjoin.cu")
    name = "_".join(str(v) for v in consts.values())
    info = {}
    so = kernels.build(src, f"gapjoin_{name}", info,
                       tuple(f"-DGJ_{k}={v}" for k, v in consts.items()))
    shutil.rmtree(src, ignore_errors=True)
    lib = kernels.bind_gap_join(ctypes.CDLL(str(so)))
    regs = re.findall(r"Used (\d+) registers", info.get("ptxas", ""))
    lib.registers = int(regs[0]) if regs else None   # ptxas -v's report
    return lib


def sweep():
    import torch
    from .ops import peaks
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(SWEEP)) as pool:    # nvcc runs in parallel
        libs = list(pool.map(_variant, SWEEP))
    lines = []
    for m, k in SWEEP_ROWS:
        args = _rows(m)[:6] + [k]
        want = _plain(args)
        first = testing.median_ms(
            lambda: testing.gap_join_first_design(*args), 30)
        for consts, lib in zip(SWEEP, libs):
            def call():
                return peaks._gap_join_cuda(*args[:6], min(k, m), lib=lib)
            peaks.SCRATCH.clear()
            got = call()
            torch.cuda.synchronize()
            if not _same(got, want):
                raise AssertionError(f"{consts} differs from plain at {m} "
                                     f"rows")
            lines.append({"mode": "sweep", "rows": m, "slots": k, **consts,
                          "registers": lib.registers,
                          "tile": consts["THREADS"] * consts["ITEMS"],
                          "grid": lib.gap_join_grid(m),
                          "ms": testing.median_ms(call, 30),
                          "first_design_ms": first,
                          "bound_ms": testing.bound(
                              testing.gap_join_bytes(m, k))[0]})
            print(json.dumps(lines[-1]), flush=True)
        peaks.SCRATCH.clear()
    return lines


def _trace_summary(buf, grid, ntiles):
    """Phase times (µs) of one traced call from its %globaltimer stamps
    (gapjoin.cu, GJ_TRACE): medians and maxima over the tiles and
    blocks, and the call's span from the first block's start."""
    b = buf.cpu().numpy()
    blk = b[16:16 + 8 * 1024].reshape(1024, 8)[:grid].astype(np.float64)
    til = b[16 + 8 * 1024:].reshape(-1, 10)[:ntiles].astype(np.float64)
    t0 = blk[:, 0].min()
    order = np.lexsort((til[:, 7], til[:, 0]))       # by block, then turn
    prev_end = np.full(ntiles, np.nan)
    for a, c in zip(order[:-1], order[1:]):
        if til[a, 0] == til[c, 0]:
            prev_end[c] = til[a, 6]
    first = np.isnan(prev_end)
    start = np.where(first, blk[til[:, 0].astype(int), 1], prev_end)

    def stat(x):
        return [float(np.median(x)) / 1e3, float(np.max(x)) / 1e3] \
            if len(x) else None
    return {"span_us": (max(blk[:, 3].max(), b[1]) - t0) / 1e3,
            "block_start_spread_us": (blk[:, 0].max() - t0) / 1e3,
            "prologue_us": stat(blk[:, 1] - blk[:, 0]),
            "wait_first_us": stat((til[:, 8] - start)[first]),
            "wait_later_us": stat((til[:, 8] - start)[~first]),
            "refill_us": stat(til[:, 1] - til[:, 8]),
            "fold_us": stat(til[:, 2] - til[:, 1]),
            "scan_us": stat(til[:, 3] - til[:, 2]),
            "agg_us": stat(til[:, 4] - til[:, 3]),
            "look_back_us": stat(til[:, 5] - til[:, 4]),
            "walk_us": stat(til[:, 6] - til[:, 5]),
            "last_inc_us": (til[:, 5].max() - t0) / 1e3,
            "done_atomic_us": stat(blk[:, 3] - blk[:, 2]),
            "last_done_us": (blk[:, 3].max() - t0) / 1e3,
            "finish_us": (b[1] - b[0]) / 1e3,
            "tiles_per_block_max": int(np.bincount(
                til[:, 0].astype(int)).max())}


def trace():
    """K5 built with GJ_TRACE, its phases stamped on the card."""
    import ctypes
    import torch
    from .ops import peaks
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _variant({"TRACE": 1})
    lib.gap_join_set_trace.argtypes = [ctypes.c_void_p]
    lib.gap_join_set_trace.restype = ctypes.c_int
    lines = []
    for m, k in SWEEP_ROWS:
        args = _rows(m)[:6] + [k]
        ntiles = (lib.gap_join_state_ints(m) - 4) // 12
        grid = lib.gap_join_grid(m)
        buf = torch.zeros(16 + 8 * 1024 + 10 * ntiles, dtype=torch.int64,
                          device="cuda")
        kernels.check(lib.gap_join_set_trace(buf.data_ptr()), "set_trace")

        def call():
            return peaks._gap_join_cuda(*args[:6], min(k, m), lib=lib)
        ms = testing.median_ms(call, 30)
        runs = []
        for _ in range(5):
            buf.zero_()
            runs.append(dict(event_ms=testing.median_ms(call, 1),
                             **_trace_summary(buf, grid, ntiles)))
        lines.append({"mode": "trace", "rows": m, "slots": k,
                      "tiles": ntiles, "grid": grid, "ms": ms,
                      "runs": runs})
        print(json.dumps(lines[-1]), flush=True)
        peaks.SCRATCH.clear()
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m genrich_tpu_torch."
                                 "gapjoin_probe")
    ap.add_argument("mode", choices=("split", "sweep", "trace"))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gapjoin_probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    lines = {"split": split, "sweep": sweep, "trace": trace}[a.mode]()
    out = a.out or os.path.join(".bench_cache", f"gapjoin_{a.mode}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": smi, "seconds": time.perf_counter() - t0,
                   "lines": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

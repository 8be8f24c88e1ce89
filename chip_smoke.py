#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genrich_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero, and the result line is printed only when every phase passed:

1. Card: name, nvidia-smi power limit; no CUDA card is an error.
2. Build: ``ingest.ensure_native()`` makes the native ingest library
   load (building native/ingest.cpp into the git-ignored
   genrich_tpu_torch/_build/ if the committed one does not), then nvcc
   builds genrich_tpu_torch/csrc there (one process per source, all at
   once); seconds and whether the ingest build has libdeflate are
   printed.
3. Kernels: each hand-written kernel against its plain PyTorch version
   on the card: coverage_scan (K1, 2^23 rows and a ragged size)
   bitwise in both modes (-log10 p of the lambda mode rtol = atol =
   1e-5), tile_stats (K2) rtol = atol = 1e-5, fisher_combine (K3, R =
   2 and 3, 2^23 lanes and a ragged size, 10% SKIP) rtol 1e-6 against
   the float64 plain version with SKIP lanes identical; median times
   with CUDA events.  The BAMs of phases 4-6 are synthesised by
   scripts/perf_synth.py into the git-ignored .bench_cache/ when
   missing.
4. Main path: the 2M-pair ATAC BAM on the 2.75 Gbp human-scale genome
   of scripts/bench_e2e.py, ``--engine exact`` once (in a subprocess,
   through the same ``ensure_native()``), then the port twice in this
   process (cold, warm) with ``-r -j -q 0.05 -a 20 --device cuda``.
   Checks: K1, K2 and K4 launched in each run, native ingest in every
   run, the peak rows against the exact engine by bench_e2e's rule
   (match_frac >= 0.99, worst_unmatched_margin <= 0.02), cold and warm
   narrowPeak byte-identical.  Then peak_reduce (K4) against its plain
   version, summit fields exact and AUC rtol 1e-5, and against the
   exact engine's float32 row-order sum, AUC bitwise: on the inputs of
   the main path's own calls (kept by one more run) and on 2^23
   synthetic rows holding about 30,000 short peaks.
5. Fisher: ``-t A,B`` with replicate B a second 2M-pair BAM (seed 8),
   the same flags; exact once, the port cold and warm.  Checks: the
   same row rule, cold == warm bytes, K1 and K2 launched 6 times, K3 3
   times, K4 at least 3 times per run.
6. Logs (depth cut to a 200,000-pair BAM: every log row is text on
   both sides): ``-f f.log -k k.log`` with the same flags, port against
   exact by ``testing.check_log``.
7. The last lines: the kernels JSON, the nvidia-smi line and
   {"ok": true, "device": {...}}; jax is never imported in this
   process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)                          # perf_synth, bench_e2e
WORK = os.path.join(REPO, ".bench_cache")
N_PAIRS = 2_000_000
N_LOG_PAIRS = 200_000
FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]   # bench_e2e.FLAGS
Q_THRESH = 1.3010299956639813                     # -log10(0.05)
M_MAIN = 1 << 23
M_RAGGED = (1 << 23) - 12_345
TOL = 1e-5
FISHER_RTOL = 1e-6
PEAKS_K4 = 30_000
DEV = "cuda"
# (pairs, seed) of each BAM: main path / Fisher replicate A, Fisher
# replicate B, logs
BAMS = {"a": (N_PAIRS, 7), "b": (N_PAIRS, 8), "log": (N_LOG_PAIRS, 7)}


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def card():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    say("card", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=smi)
    return smi.splitlines()[0]


def synth_bam(key: str) -> str:
    """The BAM of ``BAMS[key]`` in .bench_cache/, made if missing."""
    import perf_synth
    from bench_e2e import HG_CHROMS
    n, seed = BAMS[key]
    os.makedirs(WORK, exist_ok=True)
    tag = "" if seed == 7 else f"_seed{seed}"
    path = os.path.join(WORK, f"atac_e2e_hg_{n}{tag}.bam")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = path + ".tmp"
        perf_synth.synth_bam(tmp, n, seed=seed, chroms=HG_CHROMS)
        os.replace(tmp, path)
        say("synth", bam=key, pairs=n, seed=seed,
            seconds=time.perf_counter() - t0,
            mb=os.path.getsize(path) / 1e6)
    return path


# --- build ----------------------------------------------------------------

def build():
    from genrich_tpu_torch import ingest, kernels
    t0 = time.perf_counter()
    nat_info = dict(ingest.ensure_native())
    kernels.library()
    info = dict(kernels.BUILD_INFO)
    ptxas = info.pop("ptxas", "")
    info["nvcc_seconds"] = info.pop("seconds")
    say("build", wall_s=time.perf_counter() - t0, **info,
        native_ingest=nat_info)
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


# --- kernels against their plain versions ---------------------------------

def _median_ms(fn, n=20):
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _close(a, b, rtol=TOL, atol=TOL):
    import torch
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def scan_stats_phase():
    """K1 and K2 against their plain versions; returns JSON entries."""
    import torch
    from genrich_tpu_torch.ops import pileup, pipeline, scan
    dev = torch.device(DEV)
    rng = np.random.RandomState(0)
    out = {}
    for m in (M_MAIN, M_RAGGED):
        cols = []
        for _ in range(2):
            cols += [rng.randint(-1, 2, m), rng.randint(0, 8, m),
                     rng.randint(0, 3, m), rng.randint(0, 5, m)]
        d = torch.from_numpy(np.stack(cols, -1).astype(np.int32)).to(dev)
        packed = pileup.pack_deltas(d)
        del d
        carry = torch.tensor([5, 1, 2, 3, 7, 0, 1, 4], dtype=torch.int32,
                             device=dev)
        # K1, main-path mode: two groups, coverage only
        vals, _ = scan.coverage_scan(packed, 2, carry)
        ref, _ = scan.coverage_scan_plain(packed, 2, carry)
        torch.cuda.synchronize()
        g2_err = float((vals - ref).abs().max())
        if not torch.equal(vals, ref):
            raise AssertionError(f"coverage_scan G=2 M={m}: not bitwise "
                                 f"(max abs err {g2_err})")
        # K1, lambda mode: one group + -log10 p against lambda
        p1 = packed & 0x3FF
        z4 = torch.zeros(4, dtype=torch.int32, device=dev)
        v1, pv1 = scan.coverage_scan(p1, 1, z4, lam=2.5)
        rv1, rpv1 = scan.coverage_scan_plain(p1, 1, z4, lam=2.5)
        torch.cuda.synchronize()
        if not torch.equal(v1, rv1):
            raise AssertionError(f"coverage_scan G=1 M={m}: vals differ")
        p_err = float((pv1 - rpv1).abs().max())
        if not _close(pv1, rpv1):
            raise AssertionError(f"coverage_scan G=1 M={m}: p max abs "
                                 f"err {p_err}")
        # K2 on the G=2 coverage, with a 5% excluded mask
        ex = torch.from_numpy(rng.rand(m) < 0.05).to(dev)
        ev, cr = vals[0].clamp_min(0), vals[1].clamp_min(0)
        pv = pipeline.tile_stats(ev, cr, ex, 1.37, 2.5)
        rpv = pipeline.tile_stats_plain(ev, cr, ex, 1.37, 2.5)
        torch.cuda.synchronize()
        st_err = float((pv - rpv).abs().max())
        if not _close(pv, rpv):
            raise AssertionError(f"tile_stats M={m}: max abs err "
                                 f"{st_err}")
        res = {"g2_max_abs_err": g2_err, "g1_p_max_abs_err": p_err,
               "stats_max_abs_err": st_err}
        if m == M_MAIN:
            res.update(
                g2_ms=_median_ms(lambda: scan.coverage_scan(packed, 2,
                                                            carry)),
                g2_plain_ms=_median_ms(
                    lambda: scan.coverage_scan_plain(packed, 2, carry)),
                g1_ms=_median_ms(lambda: scan.coverage_scan(
                    p1, 1, z4, lam=2.5)),
                g1_plain_ms=_median_ms(lambda: scan.coverage_scan_plain(
                    p1, 1, z4, lam=2.5)),
                stats_ms=_median_ms(lambda: pipeline.tile_stats(
                    ev, cr, ex, 1.37, 2.5)),
                stats_plain_ms=_median_ms(lambda: pipeline.tile_stats_plain(
                    ev, cr, ex, 1.37, 2.5)))
        out[m] = res
        say("kernels", m=m, **res)
        del packed, vals, ref, p1, v1, pv1, rv1, rpv1, ex, ev, cr, pv, rpv
        torch.cuda.empty_cache()
    main, ragged = out[M_MAIN], out[M_RAGGED]

    def worst(key):
        return max(main[key], ragged[key])
    return [
        {"name": "coverage_scan", "route": "cuda",
         "source": "genrich_tpu_torch/csrc/scan.cu",
         "replaces": "genrich_tpu/ops/pallas_scan.py:44",
         "launches": 0, "max_abs_err": worst("g2_max_abs_err"),
         "ms": main["g2_ms"], "plain_ms": main["g2_plain_ms"],
         "mode": "G=2 coverage (main path), M=2^23",
         "lambda_mode": {"p_max_abs_err": worst("g1_p_max_abs_err"),
                         "ms": main["g1_ms"],
                         "plain_ms": main["g1_plain_ms"]}},
        {"name": "tile_stats", "route": "cuda",
         "source": "genrich_tpu_torch/csrc/stats.cu",
         "replaces": "genrich_tpu/ops/pipeline_jax.py:164",
         "launches": 0, "max_abs_err": worst("stats_max_abs_err"),
         "ms": main["stats_ms"], "plain_ms": main["stats_plain_ms"],
         "mode": "M=2^23"},
    ]


def fisher_phase():
    """K3 against its float64 plain version; returns a JSON entry."""
    import torch
    from genrich_tpu_torch.ops import chisq
    dev = torch.device(DEV)
    rng = np.random.RandomState(1)
    worst_err, worst_rel = 0.0, 0.0
    times = {}
    for r in (2, 3):
        for n in (M_MAIN, M_RAGGED):
            pv = rng.uniform(0, 8, (r, n)).astype(np.float32)
            pv[rng.rand(r, n) < 0.1] = -1.0
            pv = torch.from_numpy(pv).to(dev)
            got = chisq.fisher_combine(pv)
            want = chisq.fisher_combine_plain(pv)
            torch.cuda.synchronize()
            if not torch.equal(got == -1.0, want == -1.0):
                raise AssertionError(f"fisher_combine R={r} N={n}: SKIP "
                                     f"lanes differ")
            err = (got - want).abs()
            rel = float((err / want.abs().clamp_min(1e-30)).max())
            worst_err = max(worst_err, float(err.max()))
            worst_rel = max(worst_rel, rel)
            if not _close(got, want, rtol=FISHER_RTOL, atol=0.0):
                raise AssertionError(f"fisher_combine R={r} N={n}: max "
                                     f"rel err {rel}")
            res = {"r": r, "n": n, "max_abs_err": float(err.max()),
                   "max_rel_err": rel,
                   "skip_lanes": int((want == -1.0).sum())}
            if n == M_MAIN:
                times[r] = (_median_ms(lambda: chisq.fisher_combine(pv)),
                            _median_ms(lambda: chisq.fisher_combine_plain(
                                pv), n=5))
                res.update(ms=times[r][0], plain_ms=times[r][1])
            say("kernels", kernel="fisher_combine", **res)
            del pv, got, want, err
    torch.cuda.empty_cache()
    return {"name": "fisher_combine", "route": "cuda",
            "source": "genrich_tpu_torch/csrc/fisher.cu",
            "replaces": "genrich_tpu/ops/chisq_jax.py:174",
            "launches": 0, "max_abs_err": worst_err,
            "ms": times[2][0], "plain_ms": times[2][1],
            "mode": "R=2, N=2^23 (R=3: %.4f / %.4f ms)" % times[3],
            "max_rel_err": worst_rel}


def _hold_k4(args, min_pq):
    """K4 against its plain version (summit fields exact, AUC rtol
    1e-5) and against the exact engine's float32 row-order sum on the
    host (AUC bitwise), and twice in a row (bitwise); ``args`` are
    peak_reduce's arguments on the card.  Returns error figures."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    starts, ends, stat, _, _, sig, _, first, last, _ = args
    got = peaks.peak_reduce(*args)
    want = peaks.peak_reduce_plain(*args)
    again = peaks.peak_reduce(*args)
    torch.cuda.synchronize()
    ex = last >= first
    names = ("auc", "max_stat", "summit_pval", "summit_qval",
             "summit_pos", "summit_len")
    for name, g, w in list(zip(names, got, want))[1:]:
        if not torch.equal(g[ex], w[ex]):
            raise AssertionError(f"peak_reduce: {name} differs")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("peak_reduce: two runs differ")
    auc, plain_auc = got[0][ex], want[0][ex]
    a_err = (auc - plain_auc).abs()
    rel = float((a_err / plain_auc.abs().clamp_min(1e-30)).max())
    if not _close(auc, plain_auc, rtol=TOL, atol=0.0):
        raise AssertionError(f"peak_reduce: AUC max rel err {rel} "
                             f"against the plain version")
    host = [t.cpu().numpy() for t in (starts, ends, stat, sig, first,
                                      last, ex)]
    ref = testing.auc_rowwise(*host[:6], min_pq)[host[6]]
    n_diff = int((auc.cpu().numpy() != ref).sum())
    if n_diff:
        raise AssertionError(f"peak_reduce: AUC of {n_diff} peaks is not "
                             f"the row-order float32 sum")
    rows = (last - first + 1)[ex]
    return {"peaks": int(ex.sum()),
            "rows_per_peak_median": float(rows.double().median()),
            "rows_per_peak_max": int(rows.max()),
            "auc_max_abs_err": float(a_err.max()),
            "auc_max_rel_err": rel,
            "plain_auc_differs_bitwise": int((plain_auc.cpu().numpy()
                                              != ref).sum())}


def peaks_phase(main_calls):
    """K4 on the inputs of the main path's own calls (``main_calls``,
    host copies) and on 2^23 synthetic rows holding about 30,000 short
    peaks; returns a JSON entry whose times are the main path's."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    dev = torch.device(DEV)
    ms = plain_ms = 0.0
    worst_err = worst_rel = 0.0
    for i, call in enumerate(main_calls):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in call]
        res = _hold_k4(args, call[-1])
        res.update(rows=int(args[0].shape[0]),
                   ms=_median_ms(lambda: peaks.peak_reduce(*args)),
                   plain_ms=_median_ms(
                       lambda: peaks.peak_reduce_plain(*args)))
        ms += res["ms"]
        plain_ms += res["plain_ms"]
        worst_err = max(worst_err, res["auc_max_abs_err"])
        worst_rel = max(worst_rel, res["auc_max_rel_err"])
        say("kernels", kernel="peak_reduce", inputs=f"main path call {i}",
            **res)
        del args
    min_pq = 2.0
    ends, stat, pval, qval = testing.peak_rows(
        np.random.RandomState(2), M_MAIN, PEAKS_K4, region_rows=(3, 200),
        min_pq=min_pq)
    starts = np.concatenate([[0], ends[:-1]])
    rows = [torch.from_numpy(a).to(dev) for a in (
        starts.astype(np.int32), ends.astype(np.int32), stat, pval, qval)]
    live = torch.ones(M_MAIN, dtype=torch.bool, device=dev)
    c = peaks.peak_candidates(*rows[:3], live, min_pq, 100, 1 << 16)
    args = rows + [c.sig, c.pid, c.first, c.last, min_pq]
    syn = _hold_k4(args, min_pq)
    syn.update(rows=M_MAIN,
               ms=_median_ms(lambda: peaks.peak_reduce(*args)),
               plain_ms=_median_ms(lambda: peaks.peak_reduce_plain(*args)))
    say("kernels", kernel="peak_reduce", inputs="synthetic", **syn)
    del rows, args, c, live
    torch.cuda.empty_cache()
    return {"name": "peak_reduce", "route": "cuda",
            "source": "genrich_tpu_torch/csrc/peaks.cu",
            "replaces": "genrich_tpu/ops/peaks_jax.py:85",
            "launches": 0,
            "max_abs_err": max(worst_err, syn["auc_max_abs_err"]),
            "ms": ms, "plain_ms": plain_ms,
            "mode": f"sum over the main path's {len(main_calls)} calls, "
                    f"its own inputs; AUC bitwise to the row-order sum",
            "auc_max_rel_err": max(worst_rel, syn["auc_max_rel_err"]),
            "synthetic": {k: syn[k] for k in ("rows", "peaks", "ms",
                                               "plain_ms")}}


# --- end-to-end runs --------------------------------------------------------

def _rows(path):
    return {tuple(ln.split("\t")[:3]): ln.split("\t")
            for ln in open(path).read().splitlines()}


def _rel_diffs(ref_path, out_path):
    """Worst relative |a - b| / |a| over matched rows, per column."""
    ref, out = _rows(ref_path), _rows(out_path)
    worst = {"auc": 0.0, "p": 0.0, "q": 0.0}
    for k in ref.keys() & out.keys():
        for name, col in (("auc", 6), ("p", 7), ("q", 8)):
            a, b = float(ref[k][col]), float(out[k][col])
            if not (np.isfinite(a) and np.isfinite(b)):
                raise AssertionError(f"non-finite {name} in {k}")
            worst[name] = max(worst[name],
                              abs(a - b) / max(abs(a), 1e-30))
    return worst


def _native_used() -> bool:
    nat = sys.modules.get("genrich_tpu.ingest.native")
    return nat is not None and nat.available(build=False)


# The exact engine runs in a child process, so that this one never
# imports jax; it makes native ingest load the same way the port does
# and prints, last, whether the native library served the run.
_EXACT = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from genrich_tpu_torch.ingest import ensure_native; "
          "ensure_native(); "
          "from genrich_tpu import cli; "
          "from genrich_tpu.ingest import native; "
          "rc = cli.main(sys.argv[2:]); "
          "print(native.available(build=False)); sys.exit(rc)")


def run_exact(label: str, args):
    """``--engine exact`` on ``args`` in a child process; returns its
    wall (the child's start and imports included)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _EXACT, REPO] + args
                       + ["--engine", "exact"], capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"exact engine ({label}) exit code "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    if r.stdout.split()[-1:] != ["True"]:
        raise AssertionError(f"exact engine ({label}) used Python ingest")
    return wall


def run_port(label: str, args):
    """One port run on the card; returns (wall, launches, perf, memory)."""
    import torch
    from genrich_tpu_torch import cli, kernels
    perf = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(args + ["--device", DEV], perf=perf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"port run ({label}) exit code {rc}")
    if not _native_used():
        raise AssertionError(f"port run ({label}) used Python ingest")
    return wall, counts, perf, torch.cuda.max_memory_allocated()


def peak_runs(name: str, ts, need) -> dict:
    """Exact once, then the port cold and warm on ``-t ts``; checks the
    rows, the launch counts (``need(counts)`` returns a fault or None)
    and that cold and warm wrote the same bytes.  Returns the counts of
    the warm run."""
    from bench_e2e import _verify_rows
    run_dir = os.path.join(WORK, "chip_smoke")
    os.makedirs(run_dir, exist_ok=True)
    ref_np = os.path.join(run_dir, f"{name}_exact.np")
    wall = run_exact(name, ["-t", ts, "-o", ref_np] + FLAGS)
    say(f"{name}_exact", wall_s=wall, peaks=sum(1 for _ in open(ref_np)),
        ingest="native")
    counts = {}
    for label in ("cold", "warm"):
        out_np = os.path.join(run_dir, f"{name}_port_{label}.np")
        wall, counts, perf, mem = run_port(
            f"{name} {label}", ["-t", ts, "-o", out_np] + FLAGS)
        rows = _verify_rows(ref_np, out_np, thresh=Q_THRESH)
        diffs = _rel_diffs(ref_np, out_np)
        say(f"{name}_port_{label}", wall_s=wall, launches=counts,
            ingest="native", max_memory_allocated=mem, rows=rows,
            worst_rel_diff=diffs, perf=perf)
        fault = need(counts)
        if fault:
            raise AssertionError(f"{name} ({label}): {fault}: {counts}")
        if rows["match_frac"] < 0.99 \
                or rows["worst_unmatched_margin"] > 0.02:
            raise AssertionError(f"{name} ({label}): rows disagree with "
                                 f"the exact engine: {rows}")
    cold = open(os.path.join(run_dir, f"{name}_port_cold.np"),
                "rb").read()
    warm = open(os.path.join(run_dir, f"{name}_port_warm.np"),
                "rb").read()
    cl, wl = cold.splitlines(), warm.splitlines()
    diff = [(a, b) for a, b in zip(cl, wl) if a != b]
    say(f"{name}_repeat", cold_equals_warm=cold == warm, rows=len(wl),
        differing_rows=len(diff) + abs(len(cl) - len(wl)),
        first_differences=diff[:3])
    if cold != warm:
        raise AssertionError(f"{name}: cold and warm outputs differ")
    return counts


def main_path(bam):
    def need(c):
        missing = [k for k in ("coverage_scan", "tile_stats",
                               "peak_reduce") if c[k] <= 0]
        return f"kernels not launched: {missing}" if missing else None
    return peak_runs("main", bam, need)


def main_k4_inputs(bam):
    """One more port run of the main path (untimed, its counts unread)
    that keeps a host copy of the arguments of each peak_reduce call."""
    import torch
    from genrich_tpu_torch.ops import peaks
    calls = []
    real = peaks.peak_reduce

    def record(*args):
        calls.append([a.cpu() if torch.is_tensor(a) else a for a in args])
        return real(*args)
    peaks.peak_reduce = record
    try:
        run_port("main, K4 inputs", ["-t", bam, "-o", os.path.join(
            WORK, "chip_smoke", "main_k4_inputs.np")] + FLAGS)
    finally:
        peaks.peak_reduce = real
    if not calls:
        raise AssertionError("the main path made no peak_reduce call")
    return calls


def fisher_path(bam_a, bam_b):
    def need(c):
        want = {"coverage_scan": 6, "tile_stats": 6, "fisher_combine": 3}
        bad = {k: c[k] for k, v in want.items() if c[k] != v}
        if bad or c["peak_reduce"] < 3:
            return (f"launches differ from {want} and peak_reduce >= 3")
        return None
    return peak_runs("fisher", f"{bam_a},{bam_b}", need)


def logs_path(bam):
    run_dir = os.path.join(WORK, "chip_smoke", "logs")
    out = {}
    for side in ("exact", "port"):
        d = os.path.join(run_dir, side)
        os.makedirs(d, exist_ok=True)
        args = ["-t", bam, "-o", os.path.join(d, "out.np"),
                "-f", os.path.join(d, "f.log"),
                "-k", os.path.join(d, "k.log")] + FLAGS
        if side == "exact":
            out[side] = {"wall_s": run_exact("logs", args)}
        else:
            wall, counts, perf, mem = run_port("logs", args)
            missing = [k for k in ("coverage_scan", "tile_stats")
                       if counts[k] <= 0]
            if missing:
                raise AssertionError(f"logs: kernels not launched: "
                                     f"{missing}")
            out[side] = {"wall_s": wall, "launches": counts,
                         "max_memory_allocated": mem, "perf": perf}
    from genrich_tpu_torch import testing
    checks = {name: testing.check_log(os.path.join(run_dir, "exact", name),
                                      os.path.join(run_dir, "port", name))
              for name in ("f.log", "k.log")}
    say("logs", pairs=N_LOG_PAIRS, ingest="native", **out, **checks)


def main() -> int:
    smi = card()
    build()
    entries = scan_stats_phase() + [fisher_phase()]
    bam_a = synth_bam("a")
    main_counts = main_path(bam_a)
    entries.append(peaks_phase(main_k4_inputs(bam_a)))
    fisher_counts = fisher_path(bam_a, synth_bam("b"))
    logs_path(synth_bam("log"))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the smoke's process")
    for e in entries:
        path = fisher_counts if e["name"] == "fisher_combine" \
            else main_counts
        e["launches"] = path[e["name"]]
        e["launches_by_path"] = {"main": main_counts[e["name"]],
                                 "fisher": fisher_counts[e["name"]]}
    import torch
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

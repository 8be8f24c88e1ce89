#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genrich_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero, and the result line is printed only when every phase passed:

1. Card: name, nvidia-smi power limit; no CUDA card is an error.
2. Build: nvcc builds genrich_tpu_torch/csrc into the git-ignored
   genrich_tpu_torch/_build/ (build seconds printed).
3. Kernels: each hand-written kernel against its plain PyTorch version
   on the card at main-path sizes (2^23 rows and a ragged size):
   coverage_scan (K1) bitwise in both modes (-log10 p of the lambda
   mode rtol = atol = 1e-5), tile_stats (K2) rtol = atol = 1e-5;
   median times over 20 runs with CUDA events.
4. Main path: the 2M-pair ATAC BAM on the 2.75 Gbp human-scale genome
   of scripts/bench_e2e.py (synthesised by scripts/perf_synth.py into
   the git-ignored .bench_cache/), ``--engine exact`` once, then the
   port twice in this process (cold, warm) with ``-r -j -q 0.05 -a
   20 --device cuda``.  Checks: both kernels launched in each run, and
   the peak rows against the exact engine by bench_e2e's rule
   (match_frac >= 0.99, worst_unmatched_margin <= 0.02).
5. The last lines: the kernels JSON, the nvidia-smi line and
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "scripts"))   # perf_synth, bench_e2e
WORK = os.path.join(REPO, ".bench_cache")
N_PAIRS = 2_000_000
FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]   # bench_e2e.FLAGS
Q_THRESH = 1.3010299956639813                     # -log10(0.05)
M_MAIN = 1 << 23
M_RAGGED = (1 << 23) - 12_345
TOL = 1e-5


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


def build():
    from genrich_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    info = dict(kernels.BUILD_INFO)
    ptxas = info.pop("ptxas", "")
    info["nvcc_seconds"] = info.pop("seconds")
    say("build", wall_s=time.perf_counter() - t0, **info)
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


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


def kernels_phase():
    """Each kernel against its plain version; returns JSON entries."""
    import torch
    from genrich_tpu_torch.ops import pileup, pipeline, scan
    dev = torch.device("cuda")
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


def synth_bam(n_pairs: int) -> str:
    import perf_synth
    from bench_e2e import HG_CHROMS
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"atac_e2e_hg_{n_pairs}.bam")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = path + ".tmp"
        perf_synth.synth_bam(tmp, n_pairs, chroms=HG_CHROMS)
        os.replace(tmp, path)
        say("synth", n_pairs=n_pairs, seconds=round(
            time.perf_counter() - t0, 2), mb=os.path.getsize(path) / 1e6)
    return path


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


def main_path():
    """Exact engine once, then the port cold and warm; returns the
    launch counts of the warm run."""
    import torch
    from bench_e2e import _verify_rows
    from genrich_tpu_torch import cli, kernels
    bam = synth_bam(N_PAIRS)
    run_dir = os.path.join(WORK, "chip_smoke")
    os.makedirs(run_dir, exist_ok=True)
    ref_np = os.path.join(run_dir, "exact.np")
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "genrich_tpu", "-t", bam,
                        "-o", ref_np, "--engine", "exact"] + FLAGS,
                       cwd=run_dir, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise AssertionError(f"exact engine failed: {r.stderr[-2000:]}")
    say("exact", wall_s=time.perf_counter() - t0,
        peaks=sum(1 for _ in open(ref_np)))
    counts = {}
    for label in ("cold", "warm"):
        out_np = os.path.join(run_dir, f"port_{label}.np")
        perf = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-t", bam, "-o", out_np] + FLAGS
                      + ["--device", "cuda"], perf=perf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"port run ({label}) exit code {rc}")
        nat = sys.modules.get("genrich_tpu.ingest.native")
        ingest = "native" if nat is not None \
            and nat.available(build=False) else "python"
        rows = _verify_rows(ref_np, out_np, thresh=Q_THRESH)
        diffs = _rel_diffs(ref_np, out_np)
        say(f"port_{label}", wall_s=wall, launches=counts, ingest=ingest,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            rows=rows, worst_rel_diff=diffs, perf=perf)
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the main path was not "
                                 f"launched: {counts}")
        if rows["match_frac"] < 0.99 \
                or rows["worst_unmatched_margin"] > 0.02:
            raise AssertionError(f"rows disagree with the exact engine: "
                                 f"{rows}")
    cold = open(os.path.join(run_dir, "port_cold.np")).read().splitlines()
    warm = open(os.path.join(run_dir, "port_warm.np")).read().splitlines()
    diff = [(a, b) for a, b in zip(cold, warm) if a != b]
    say("repeat", cold_equals_warm=cold == warm, rows=len(warm),
        differing_rows=len(diff) + abs(len(cold) - len(warm)),
        first_differences=diff[:3])
    return counts


def main() -> int:
    smi = card()
    build()
    entries = kernels_phase()
    counts = main_path()
    for e in entries:
        e["launches"] = counts[e["name"]]
    import torch
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark of the port on one card: kernel legs and end-to-end legs.

    python -m genrich_tpu_torch.bench [--device cuda|cpu] [--kernel-only]
        [--configs atac,control,fisher,chip,chip_fisher] [--reps N]
        [--out PATH]
    python -m genrich_tpu_torch.bench --scaling [--device cuda|cpu]
        [--reps N] [--out PATH]
    python -m genrich_tpu_torch.bench --mem [N ...] [--device cuda|cpu]
        [--reps N] [--out PATH]
    python -m genrich_tpu_torch.bench --overlap [N ...] [--out PATH]

The port's counterpart of the repo's ``bench.py`` and
``scripts/bench_e2e.py``, which drive the JAX package.  It imports
neither ``jax`` nor ``genrich_tpu`` and keeps its own copies of what it
takes from them.  It runs on the card unless ``--device cpu`` is given;
without a card it fails.

Kernel legs (``kernel_legs``), the shapes of ``bench.py``: a genome of
``GENOME_LEN`` bp scanned as tiles of ``TILE_LEN`` bp with
``EVENTS_PER_TILE`` fragment events each, drawn from
``np.random.RandomState(0)`` by ``bench.py``'s draws (``_tile_events``).
- Light: each tile through ``ops/pipeline.py::analyze_tile_core`` (the
  sort, K1 in lambda mode, K5, K4); a dispatch is ``BATCH`` tiles
  launched with no host sync between them, ending in one fetch of
  their fragment sums, which must be equal in every dispatch and rep.
  Then the same tile dispatched alone ``N_SINGLE`` times.
- Production: ``analyze_tile_ctrl`` (K1 in coverage mode, K2, K5, K4)
  on ``BATCH_PROD`` tiles with a control channel of the same events and
  ``K_EXCL`` padded exclusions.
Both are timed by the host clock and by CUDA events; beside them the
device-memory bandwidth (64 read and write passes over 64 MiB, best of
5), ``bench.py``'s ideal-sort byte model of a tile and the sum of the
hand kernels' bounds (``testing.bound``) over one tile's calls.

End-to-end legs (``bench_e2e``): the 2M-pair BAMs that ``chip_smoke.py``
caches in ``.bench_cache/`` (``BAMS``; made by ``tools/perf_synth.py``,
the port's copy of ``scripts/perf_synth.py``, in child processes when
missing), five configurations (``CONFIGS``), each on ``--engine exact -v`` in a child process and on ``--engine
jax`` and ``--engine sharded`` through one ``--serve`` child each (no
process group: the sharded one spans every card the child sees).  A cold
line per device engine, then ``reps`` paired reps: the exact run, then
one serve line of each device engine.  Each device output must pass
``_verify_rows`` against the exact engine's and equal its cold output
byte for byte; a failed check fails the bench.  The compiled-reference
leg of ``scripts/bench_e2e.py`` is left out (it needs the Genrich
sources), so the headline's ``e2e_exact_ratio`` is the paired exact /
``--engine jax`` wall ratio on ``atac``.

The full dict goes to ``.bench_cache/bench_torch_detail.json`` (or
``--out``); the last stdout line is ``compact_headline``, with
``bench.py``'s keys and the card's name and power limit.

The scaling leg (``--scaling``, alone), the counterpart of
``scripts/bench_scaling.py``: the script's fixed work (8 tiles of 2^16
bp, 4,096 events a tile, a control, an exclusion, q-values, peaks
across a tile boundary) and a rung at the light tile's size (8 tiles of
2^24 bp, 2^19 events a tile), each through ``sharded_analyze_full`` and
``merge_tile_peaks`` over D = 1, 2, 4 and 8 shards, warm, median of 9,
in three forms: D contexts on ``cuda:0``; D cards, where the host has
them; two NCCL ranks of D/2 cards each, in child processes, where the
host has D cards.  It writes ``.bench_cache/bench_torch_scaling.json``
(or ``--out``) and prints it as the last line: per rung and form the
script's ``t_ms_by_D``, ``overhead_pct_by_D`` and
``efficiency_pct_by_D`` (against one context), and it fails unless
every leg's peaks are D = 1's.

The scale ladder (``--mem``, alone), the counterpart of
``scripts/bench_mem.py``: rungs of 2M, 10M, 40M and 60M read pairs
(perf_synth's seed 7 on ``HG_CHROMS``, cached under ``bench_e2e``'s
names; every missing BAM made at once first, read once for the page
cache), ``-r -j -q 0.05 -a 20``.  A rung starts a fresh serve child per
device engine (its first line the cold run), then runs ``MEM_ORDER``,
the script's balanced order over three contenders (exact, jax, sharded,
sharded, jax, exact, exact, jax, sharded; ``--reps`` r takes 3r legs),
the exact legs ``--engine exact -v`` children under
``GENRICH_NATIVE_PROF=1 GENRICH_TPU_PROFILE=1`` (the script's phase
split, ``PHASE_RES``); every child's own peak RSS (``RssSampler``).
Each engine's ratios come from its temporally adjacent (exact, engine)
pairs, as the script pairs its legs.  Checks: the exact reps
byte-identical; every device engine's rows against the exact output,
its summits, cold == warm bytes, no host peak call, K1, K2, K5 and K4
launched on every card in every line
(``launches_by_card`` of the serve line).  The script's compiled-
reference legs are left out (they need the Genrich sources).  The
detail goes to ``.bench_cache/bench_torch_mem.json`` (or ``--out``)
after every rung; the last line is ``compact_ladder``'s.

The ingest-overlap legs (``--overlap``, alone), the counterpart of
``scripts/bench_overlap.py``, on the port's exact engine at 10M and
40M pairs: seq (``GENRICH_INGEST_THREADS=0``), par2 (``=2``), par2,
seq, then the default (the variable unset: ``default_workers`` on this
host) twice and ``frame_only`` (``GENRICH_ABLATE=frame``); the detail
goes to ``.bench_cache/bench_torch_overlap.json`` (or ``--out``) and is
the last line.  A failed check of either fails the bench (exit code 1).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import resource
import shlex
import shutil
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

from . import testing
from .ops import peaks as peaks_ops
from .ops import pipeline as tile_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, ".bench_cache")
DETAIL = os.path.join(WORK, "bench_torch_detail.json")

# bench.py's shapes
GENOME_LEN = 2_826_865_605          # Genrich's README example (hg19)
BASELINE_POS_PER_SEC = 4.5e6        # Genrich's published single-core rate
TILE_LEN = 1 << 24
EVENTS_PER_TILE = 1 << 19
BATCH = 48                          # tiles per dispatch
BATCH_PROD = 8
REPS = 7
PROD_REPS = 3
N_SINGLE = 16                       # single-tile dispatches
K_EXCL = 64                         # padded exclusions of a production tile
MIN_PQ, MIN_AUC, MIN_LEN, MAX_GAP = 2.0, 20.0, 0, 100

# scripts/bench_e2e.py's genome and flags, chip_smoke.py's BAMs
HG_CHROMS = (("chr1", 1_100_000_000), ("chr2", 900_000_000),
             ("chr3", 750_000_000))
E2E_FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]
CHIP_FLAGS = ["-r", "-p", "0.01", "-a", "20"]     # + -E blk.bed -e chr3
BAMS = {"A": (2_000_000, 7), "B": (2_000_000, 8), "C": (1_000_000, 9)}
# name -> (treatment BAMs, control BAMs, ChIP flags): Genrich's ATAC use
# alone, against a control and on two replicates, then its ChIP use
CONFIGS = {"atac": ("A", "", False), "control": ("A", "B", False),
           "fisher": ("A,B", "", False), "chip": ("A", "B", True),
           "chip_fisher": ("A,B", "C,C", True)}
Q_THRESH = 1.3010299956639813       # -log10(0.05): -q 0.05
P_THRESH = 2.0                      # -log10(0.01): -p 0.01
ENGINES = ("jax", "sharded")
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


# --- kernel legs ----------------------------------------------------------

def _tile_events(rng, n_variants=4, tile_len=TILE_LEN,
                 events=EVENTS_PER_TILE):
    """Distinct per-tile event sets (clustered + background), by
    ``bench.py``'s draws from ``rng``."""
    variants = []
    for _ in range(n_variants):
        hot = rng.randint(0, tile_len - 2000, 64)
        which = rng.randint(0, 64, events)
        is_hot = rng.rand(events) < 0.7
        base = np.where(is_hot, hot[which] + rng.randint(0, 1500, events),
                        rng.randint(0, tile_len - 500, events))
        frag = rng.randint(80, 400, events)
        start = np.clip(base, 0, tile_len - 1).astype(np.int32)
        end = np.clip(base + frag, 1, tile_len).astype(np.int32)
        count = rng.choice([1, 1, 1, 1, 2, 4], events).astype(np.int32)
        variants.append((start, end, count))
    return variants


def tile_lambda(tile_len, events):
    """The light tiles' background rate, as ``bench.py`` sets it."""
    return float(np.float32(events * 200.0 / tile_len))


def upload_batch(variants, batch, device):
    """The variants on the device, as a [batch, E] (start, end, count)
    triple whose row i is variant i mod len(variants), built there."""
    n = -(-batch // len(variants))
    return tuple(torch.as_tensor(np.stack([v[j] for v in variants]),
                                 device=device).repeat(n, 1)[:batch]
                 for j in range(3))


def light_tile(s, e, c, tile_len, lam, carry):
    """One light tile: ``analyze_tile_core`` with bench.py's arguments."""
    return tile_ops.analyze_tile_core(s, e, c, tile_len, carry, lam, MIN_PQ,
                                      MIN_AUC, MIN_LEN, MAX_GAP)


def prod_tile(s, e, c, excl, tile_len, lam, carry):
    """One production tile: ``analyze_tile_ctrl`` with a control channel
    of the same events; returns (TileResult, control fragment sum)."""
    res, ctrl_frag, *_ = tile_ops.analyze_tile_ctrl(
        s, e, c, s, e, c, excl, tile_len, carry, carry, lam, 1.0, MIN_PQ,
        MIN_AUC, MIN_LEN, MAX_GAP)
    return res, ctrl_frag


def light_dispatch(batch, tile_len, lam):
    """Every tile of ``batch`` through ``light_tile``, no host sync
    between them; the float32 sum of their fragment sums (on the
    device)."""
    s, e, c = batch
    carry = torch.zeros(4, dtype=torch.int32, device=s.device)
    return torch.stack([light_tile(s[i], e[i], c[i], tile_len, lam,
                                   carry).frag_len
                        for i in range(s.shape[0])]).sum()


def prod_excl(tile_len, device):
    """``K_EXCL`` exclusions, all padding (tile_len, tile_len)."""
    return torch.full((K_EXCL, 2), tile_len, dtype=torch.int32,
                      device=device)


def prod_dispatch(batch, excl, tile_len, lam):
    """Every tile of ``batch`` through ``prod_tile``; the float32 sum of
    their treatment and control fragment sums."""
    s, e, c = batch
    carry = torch.zeros(4, dtype=torch.int32, device=s.device)
    parts = []
    for i in range(s.shape[0]):
        res, ctrl_frag = prod_tile(s[i], e[i], c[i], excl, tile_len, lam,
                                   carry)
        parts.append(res.frag_len + ctrl_frag)
    return torch.stack(parts).sum()


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _spread_pct(xs):
    """(max - min) / median, in percent."""
    return 100.0 * (max(xs) - min(xs)) / _median(xs)


def timed_reps(device, fn, n_dispatch, reps):
    """``reps`` reps of ``n_dispatch`` dispatches of ``fn`` each, their
    values fetched at the end of the rep: the host seconds of each rep
    and, on a card, the CUDA events' seconds from before the first
    launch to after the last kernel; every value must be equal
    (raises)."""
    cuda = device.type == "cuda"
    host, dev_s, first = [], [], None
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        outs = [fn() for _ in range(n_dispatch)]
        if cuda:
            b.record()
        vals = [float(o) for o in outs]
        host.append(time.perf_counter() - t0)
        if cuda:
            dev_s.append(a.elapsed_time(b) / 1e3)
        first = vals[0] if first is None else first
        if any(v != first for v in vals):
            raise AssertionError(f"non-deterministic dispatch: {vals} "
                                 f"against {first}")
    return host, (dev_s or None), first


def host_syncs(device, fn):
    """The host syncs one call of ``fn`` makes
    (``torch.cuda.set_sync_debug_mode``'s warnings) and the source lines
    that made them; (None, []) on the CPU."""
    if device.type != "cuda":
        return None, []
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    return len(syncs), sorted({f"{os.path.relpath(w.filename, REPO)}:"
                               f"{w.lineno}" for w in syncs})


def measure_hbm_bw(device, iters=64, reps=5):
    """Device-memory bytes/s of 64 read and write passes over a 64 MiB
    float32 array (one kernel each), best of ``reps``, by CUDA events."""
    x = torch.ones(1 << 24, dtype=torch.float32, device=device)
    c = 1.0000001

    def run():
        for _ in range(iters):
            x.mul_(c)
    run()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    return iters * 2.0 * x.nbytes / best


KERNEL_TARGETS = ((tile_ops, "coverage_scan"), (tile_ops, "tile_stats"),
                  (peaks_ops, "peak_candidates"),
                  (peaks_ops, "peak_reduce"))
WRAPPER_KERNEL = {"peak_candidates": "gap_join"}


def tile_calls(fn):
    """One call of ``fn`` (a tile) with the arguments of every hand-kernel
    call recorded: {kernel: [args, ...]} (``kernels.LAUNCHES``'s names)."""
    with testing.recording(KERNEL_TARGETS) as calls:
        fn()
    return {WRAPPER_KERNEL.get(k, k): v for k, v in calls.items() if v}


def kernel_bounds(calls):
    """The hand kernels' bounds over these calls: each call's
    ``testing.bound`` from its bytes and operations (``call_work``),
    summed per kernel and over all."""
    out, total = {}, 0.0
    for name, cs in calls.items():
        parts = [testing.call_work(name, args) for args in cs]
        ms = [testing.bound(p["bytes"], p["fp32_ops"], p["fp64_ops"])
              for p in parts]
        out[name] = {"calls": len(cs),
                     "bytes": sum(p["bytes"] for p in parts),
                     "fp32_ops": sum(p["fp32_ops"] for p in parts),
                     "fp64_ops": sum(p["fp64_ops"] for p in parts),
                     "bound_ms": sum(m for m, _ in ms),
                     "bound_by": sorted({b for _, b in ms})}
        total += out[name]["bound_ms"]
    return out, total


def roofline(bw, n_rows, sort_payload_sum_b, chain_bytes_per_row,
             t_tile_s, kernel_bound_ms):
    """``bench.py``'s speed-of-light byte model of one tile, its ideal
    sort only: ``log2 M`` merge passes over the sorted payloads plus the
    chain's bytes per row, at the measured bandwidth ``bw``; beside it
    the hand kernels' summed bounds over the tile's calls."""
    logm = math.ceil(math.log2(n_rows))
    b_ideal = 2.0 * n_rows * sort_payload_sum_b * logm \
        + float(n_rows) * chain_bytes_per_row
    return {"hbm_bw_gbps": bw / 1e9,
            "model": {"rows": n_rows,
                      "sort_payload_sum_b": sort_payload_sum_b,
                      "merge_passes": logm,
                      "chain_bytes_per_row": chain_bytes_per_row},
            "bytes_ideal_sort_mb": b_ideal / 1e6,
            "t_model_ideal_ms": 1e3 * b_ideal / bw,
            "t_measured_ms": 1e3 * t_tile_s,
            "frac_vs_ideal_sort": b_ideal / bw / t_tile_s,
            "hand_kernel_bound_ms": kernel_bound_ms,
            "frac_vs_hand_kernel_bound": kernel_bound_ms / 1e3 / t_tile_s}


def kernel_legs(device, reps=REPS, prod_reps=PROD_REPS, tile_len=TILE_LEN,
                events=EVENTS_PER_TILE, batch=BATCH, batch_prod=BATCH_PROD,
                genome_len=GENOME_LEN, n_single=N_SINGLE):
    """The light and production legs, the bandwidth and the rooflines
    (the last two on a card only); returns the detail dict's kernel
    part."""
    n_dispatch = -(-genome_len // (tile_len * batch))
    n_disp_prod = max(4, 64 // batch_prod)
    scanned_bp = n_dispatch * batch * tile_len
    variants = _tile_events(np.random.RandomState(0), tile_len=tile_len,
                            events=events)
    lam = tile_lambda(tile_len, events)
    light = upload_batch(variants, batch, device)
    prod = upload_batch(variants, batch_prod, device)
    excl = prod_excl(tile_len, device)
    one = tuple(x[:1] for x in light)
    zero4 = torch.zeros(4, dtype=torch.int32, device=device)

    def light_fn():
        return light_dispatch(light, tile_len, lam)

    def prod_fn():
        return prod_dispatch(prod, excl, tile_len, lam)

    def single_fn():
        return light_tile(one[0][0], one[1][0], one[2][0], tile_len, lam,
                          zero4).frag_len

    t0 = time.perf_counter()
    for fn in (light_fn, prod_fn, single_fn):    # warm up: build, allocate
        float(fn())
    warm_s = time.perf_counter() - t0
    syncs = {"light": host_syncs(device, light_fn),
             "production": host_syncs(device, prod_fn)}
    rep_s, rep_dev_s, light_sum = timed_reps(device, light_fn, n_dispatch,
                                             reps)
    single_s, single_dev_s, _ = timed_reps(device, single_fn, n_single, 1)
    prod_s, prod_dev_s, prod_sum = timed_reps(device, prod_fn, n_disp_prod,
                                              prod_reps)
    med, prod_med = _median(rep_s), _median(prod_s)
    tiles, tiles_prod = n_dispatch * batch, n_disp_prod * batch_prod
    per_tile_ms = 1e3 * med / tiles
    per_tile_prod_ms = 1e3 * prod_med / tiles_prod
    per_tile_single_ms = 1e3 * single_s[0] / n_single
    light_calls = tile_calls(single_fn)
    prod_calls = tile_calls(lambda: prod_tile(*(x[0] for x in prod), excl,
                                              tile_len, lam, zero4))
    light_bounds, light_bound_ms = kernel_bounds(light_calls)
    prod_bounds, prod_bound_ms = kernel_bounds(prod_calls)
    value = scanned_bp / med
    prod_rate = tile_len / (per_tile_prod_ms / 1e3)
    out = {
        "metric": "genome_positions_per_sec", "value": value,
        "unit": "positions/s", "vs_baseline": value / BASELINE_POS_PER_SEC,
        "kernel": {
            "tiles": tiles, "batch": batch, "events_per_tile": events,
            "tile_len": tile_len, "dispatches": n_dispatch,
            "rep_s": rep_s, "median_s": med, "spread_pct": _spread_pct(rep_s),
            "rep_device_s": rep_dev_s,
            "per_tile_ms_batched": per_tile_ms,
            "per_tile_device_ms_batched": None if rep_dev_s is None
            else 1e3 * _median(rep_dev_s) / tiles,
            "per_tile_ms_single_dispatch": per_tile_single_ms,
            "per_tile_device_ms_single_dispatch": None
            if single_dev_s is None else 1e3 * single_dev_s[0] / n_single,
            "dispatch_overhead_ms": per_tile_single_ms - per_tile_ms,
            "dispatch_sum": light_sum,
            "host_syncs_per_dispatch": syncs["light"][0],
            "host_sync_sites": syncs["light"][1], "kernel_calls_per_tile": {
                k: len(v) for k, v in light_calls.items()},
            "kernel_bounds_per_tile": light_bounds,
        },
        "kernel_production": {
            "tiles_per_dispatch": batch_prod, "dispatches": n_disp_prod,
            "events_per_tile_per_channel": events, "rep_s": prod_s,
            "rep_device_s": prod_dev_s, "per_tile_ms": per_tile_prod_ms,
            "per_tile_device_ms": None if prod_dev_s is None
            else 1e3 * _median(prod_dev_s) / tiles_prod,
            "positions_per_sec": prod_rate,
            "vs_baseline": prod_rate / BASELINE_POS_PER_SEC,
            "dispatch_sum": prod_sum,
            "host_syncs_per_dispatch": syncs["production"][0],
            "host_sync_sites": syncs["production"][1],
            "kernel_calls_per_tile": {
                k: len(v) for k, v in prod_calls.items()},
            "kernel_bounds_per_tile": prod_bounds,
        },
        "warmup_s": warm_s,
    }
    if device.type == "cuda":
        bw = measure_hbm_bw(device)
        # light: M = 2E + 1 rows; the sorted payloads (bench.py's model:
        # the event sort's 4 + 4 B and two 20 B and 16 B lexicographic
        # sorts), ~64 B a row of chain; production: expt and control
        # points and the exclusions, ~96 B a row (two groups)
        out["kernel"]["roofline"] = roofline(
            bw, 2 * events + 1, 8 + 20 + 16, 64, per_tile_ms / 1e3,
            light_bound_ms)
        out["kernel_production"]["roofline"] = roofline(
            bw, 4 * events + 2 * K_EXCL + 1, 8 + 20 + 16, 96,
            per_tile_prod_ms / 1e3, prod_bound_ms)
    else:
        out["kernel"]["roofline"] = out["kernel_production"]["roofline"] = {
            "frac_vs_ideal_sort": None, "note": "not measured: no card"}
    return out


# --- scaling leg ------------------------------------------------------------

# scripts/bench_scaling.py's rung (8 tiles of 2^16 bp, 4,096 events a
# tile), then the light tile's size, where the card has work to do
SCALING_RUNGS = ((8, 1 << 16, 1 << 12), (8, TILE_LEN, EVENTS_PER_TILE))
SCALING_DS = (1, 2, 4, 8)
SCALING_REPS = 9
SCALING_OUT = os.path.join(WORK, "bench_torch_scaling.json")


def scaling_fixture(tiles, tile_len, events_per_tile):
    """``scripts/bench_scaling.py``'s fixed work: background events and
    two clusters (one inside tile 0, one across the last tile boundary)
    with a control of as many background events, split into
    [tiles, w] rows of one width, and one exclusion in tile 0; drawn
    from ``np.random.RandomState(7)`` by the script's draws."""
    from .parallel.mesh import split_events_to_tiles
    genome = tiles * tile_len
    rng = np.random.RandomState(7)
    n = tiles * events_per_tile

    def events(n_bg, clusters):
        s = [rng.randint(0, genome - 256, n_bg)]
        for (lo, hi, k) in clusters:
            s.append(rng.randint(lo, hi, k))
        s = np.concatenate(s).astype(np.int64)
        e = np.minimum(s + rng.randint(40, 200, len(s)), genome)
        return s, e, np.ones(len(s), np.int32)

    b = (tiles - 1) * tile_len
    expt = events(n, [(tile_len // 2, tile_len // 2 + 400, n // 8),
                      (b - 300, b + 300, n // 8)])
    ctrl = events(n, [])
    t = split_events_to_tiles(*expt, tiles, tile_len)
    c = split_events_to_tiles(*ctrl, tiles, tile_len)
    w = 1
    while w < max(t[0].shape[1], c[0].shape[1]):
        w <<= 1

    def pad(a, v):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])), constant_values=v)
    excl = np.full((tiles, 1, 2), tile_len, np.int32)
    excl[0, 0] = (100, 300)
    return (pad(t[0], tile_len), pad(t[1], tile_len), pad(t[2], 0),
            pad(c[0], tile_len), pad(c[1], tile_len), pad(c[2], 0), excl,
            tile_len, genome)


def scaling_leg(devices, fixture, reps=SCALING_REPS, procs=None):
    """The script's ``time_leg`` over a ``CardGroup`` of ``devices``
    (and the ranks of ``procs``): each shard's block of tiles on its
    device, then ``sharded_analyze_full`` (q-values on) and
    ``merge_tile_peaks``, once to warm up and ``reps`` times timed by
    the host clock (the merge reads the peaks on the host, so every
    card has finished).  Returns (median seconds, merged peaks as
    JSON-able rows)."""
    from .ops.peaks import TilePeaks
    from .ops.pipeline import TileResult
    from .parallel import mesh
    arrays, (tile_len, genome) = fixture[:7], fixture[7:]
    cards = mesh.CardGroup(devices, procs)
    per = arrays[0].shape[0] // cards.size
    blocks = [slice((cards.first + c) * per, (cards.first + c + 1) * per)
              for c in range(cards.n_local)]
    args = [[torch.as_tensor(x[b], device=d)
             for b, d in zip(blocks, cards.devices)] for x in arrays]
    kern = mesh.ShardedKernels(tile_len, group=cards)

    def step():
        res, _, _ = mesh.sharded_analyze_full(
            *args, tile_len, genome, 1.0, 2.0, 0, 100, True, kern=kern,
            group=cards)
        host = TilePeaks(*(f.cpu().numpy() for f in res.peaks))
        return mesh.merge_tile_peaks(TileResult(host, None, None), tile_len,
                                     2.0, 0, 100)
    merged = step()
    if not merged:
        raise AssertionError("the scaling fixture must produce peaks")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    return _median(times), [[int(p[0]), int(p[1]), float(p[2]),
                             float(p[3]), float(p[4]), int(p[5])]
                            for p in merged]


# A rank of the scaling leg's "ranks" form: argv is the repo and the
# rank's settings as JSON; prints its median seconds and peaks.
_SCALING_RANK = """
import json, sys
sys.path.insert(0, sys.argv[1])
from genrich_tpu_torch import bench
print(json.dumps(bench.scaling_rank(json.loads(sys.argv[2]))))
"""


def scaling_rank(cfg):
    """One rank of a two-rank leg: joins the process group from the
    environment (NCCL on CUDA, gloo on the CPU), then ``scaling_leg``
    over its ``cfg["devices"]``."""
    import torch.distributed as dist
    from .parallel.distributed import init_distributed
    procs = init_distributed(cfg["devices"])
    try:
        t, peaks = scaling_leg(cfg["devices"],
                               scaling_fixture(*cfg["rung"]), cfg["reps"],
                               procs)
    finally:
        dist.destroy_process_group()
    return {"t_s": t, "peaks": peaks}


def _rank_legs(devices_by_rank, rung, reps, timeout=900):
    """``scaling_rank`` in one child process a rank (no jax imported),
    all started together; returns each rank's result.  CPU ranks share
    the host's cores (each spinning on all of them slows gloo's
    collectives dozens of times over)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n = len(devices_by_rank)
    env = _env({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "WORLD_SIZE": str(n), "GLOO_SOCKET_IFNAME": "lo"})
    if torch.device(devices_by_rank[0][0]).type == "cpu":
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or n) // n))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SCALING_RANK, REPO, json.dumps(
            {"devices": devs, "rung": list(rung), "reps": reps})],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for r, devs in enumerate(devices_by_rank)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"scaling rank {r}: exit code "
                               f"{p.returncode}: {err[-2000:]}")
    return [json.loads(out.splitlines()[-1]) for out, _ in logs]


def scaling_forms(device, ds):
    """{form: {D: devices}}: "contexts", D shards on one device
    (``cuda:0`` or the CPU); "cards", D cards of this host, where it has
    them; "ranks", two ranks of D/2 devices each (distinct cards on
    CUDA: NCCL takes no two ranks on one card; CPU contexts under
    gloo)."""
    if device.type == "cpu":
        return {"contexts": {d: ["cpu"] * d for d in ds},
                "ranks": {d: [["cpu"] * (d // 2)] * 2
                          for d in ds if d >= 2 and d % 2 == 0}}
    n = torch.cuda.device_count()
    cards = [f"cuda:{i}" for i in range(n)]
    return {"contexts": {d: ["cuda:0"] * d for d in ds},
            "cards": {d: cards[:d] for d in ds if 2 <= d <= n},
            "ranks": {d: [cards[:d // 2], cards[d // 2:d]]
                      for d in ds if d >= 2 and d % 2 == 0 and d <= n}}


def scaling(device, ds=SCALING_DS, rungs=SCALING_RUNGS, reps=SCALING_REPS):
    """``scripts/bench_scaling.py`` on the port: each rung's fixed work
    (``scaling_fixture``) over D = ``ds`` shards in each form of
    ``scaling_forms``, the same total work at every D.  Per form
    ``t_ms_by_D`` (the median leg), ``overhead_pct_by_D`` and
    ``efficiency_pct_by_D`` against one context's t(1), under the
    script's names; every leg's peaks must equal D = 1's (raises)."""
    if device.type == "cuda":
        from . import kernels
        kernels.library()
    out = {"device": card_line(device), "cards": torch.cuda.device_count()
           if device.type == "cuda" else 0, "reps": reps, "rungs": []}
    for rung in rungs:
        fixture = scaling_fixture(*rung)
        forms = {}
        base = peaks0 = None
        for form, by_d in scaling_forms(device, ds).items():
            if not by_d:
                continue
            t_ms = {}
            for d, devs in by_d.items():
                if form == "ranks":
                    got = _rank_legs(devs, rung, reps)
                    t = max(g["t_s"] for g in got)
                    legs = [g["peaks"] for g in got]
                else:
                    t, peaks = scaling_leg(devs, fixture, reps)
                    legs = [peaks]
                peaks0 = legs[0] if peaks0 is None else peaks0
                if any(p != peaks0 for p in legs):
                    raise AssertionError(f"{form} D={d}: peaks differ from "
                                         f"D=1's")
                t_ms[str(d)] = 1e3 * t
                base = t_ms[str(d)] if base is None else base
            forms[form] = {
                "devices": {str(d): v for d, v in by_d.items()},
                "t_ms_by_D": t_ms,
                "overhead_pct_by_D": {d: 100.0 * (t - base) / base
                                      for d, t in t_ms.items()},
                "efficiency_pct_by_D": {d: 100.0 * base / t
                                        for d, t in t_ms.items()}}
        out["rungs"].append({"tiles": rung[0], "tile_len": rung[1],
                             "events_per_tile": rung[2],
                             "peaks": len(peaks0), "forms": forms})
    return out


# --- end-to-end legs ------------------------------------------------------

def bam_path(key, work=WORK):
    """``chip_smoke.py``'s cache name of BAM ``key`` of ``BAMS``."""
    n, seed = BAMS[key]
    tag = "" if seed == 7 else f"_seed{seed}"
    return os.path.join(work, f"atac_e2e_hg_{n}{tag}.bam")


# tools/perf_synth.py in a child process: argv is the repo root, the
# output path, the pairs, the seed and the chromosomes as JSON
_SYNTH = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
          "from genrich_tpu_torch.tools import perf_synth; "
          "perf_synth.synth_bam(sys.argv[2], int(sys.argv[3]), "
          "seed=int(sys.argv[4]), "
          "chroms=[tuple(c) for c in json.loads(sys.argv[5])])")


def synth(jobs, chroms=HG_CHROMS):
    """Each missing BAM of ``jobs`` ({key: (path, pairs, seed)}) made by
    ``tools/perf_synth.py`` in a child process, all at once; returns
    {key: (path, seconds or None when it was there)}."""
    procs, made = {}, {}
    t0 = time.perf_counter()
    for key, (path, n, seed) in jobs.items():
        made[key] = (path, None)
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            procs[key] = subprocess.Popen(
                [sys.executable, "-c", _SYNTH, REPO, path + ".tmp",
                 str(n), str(seed), json.dumps(chroms)],
                stdout=subprocess.DEVNULL)
    try:
        for key, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"perf_synth of BAM {key}: exit code "
                                   f"{proc.returncode}")
            path = jobs[key][0]
            os.replace(path + ".tmp", path)
            made[key] = (path, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return made


def make_bams(keys, work=WORK, chroms=HG_CHROMS):
    """The BAMs of ``keys`` in ``work`` (``synth``).  Returns {key:
    path}."""
    made = synth({key: (bam_path(key, work), *BAMS[key]) for key in keys},
                 chroms)
    return {key: path for key, (path, _) in made.items()}


def _env(extra=None, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in DIST_ENV and k not in drop}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


class RssSampler:
    """The peak resident size of process ``pid``, read from
    /proc/<pid>/statm every 20 ms by a thread of this process until
    ``stop``.  wait4's ru_maxrss of a child also counts the high-water
    mark of the parent it was forked from (on the H100 host every exact
    child read the bench process's 4.6 GB), and the H100 host's /proc
    gives no VmHWM, so the child's resident size is sampled."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    def __init__(self, pid, period=0.02):
        self.path = f"/proc/{pid}/statm"
        self.peak = 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period,),
                                        daemon=True)
        self._thread.start()

    def _read(self):
        try:
            with open(self.path) as f:
                return int(f.read().split()[1]) * self.PAGE
        except (OSError, ValueError, IndexError):
            return 0

    def _run(self, period):
        while not self._done.is_set():
            self.peak = max(self.peak, self._read())
            self._done.wait(period)

    def stop(self):
        """Ends the sampling; the peak in MB, None when no read saw the
        process."""
        self._done.set()
        self._thread.join()
        return self.peak / 2**20 or None


def _run_rss(cmd, cwd, timeout, extra_env=None, drop=()):
    """One run: (wall_s, rc, stderr_text, peak_rss_mb); the variables of
    ``drop`` unset in its environment.  The RSS is the child's own
    (``RssSampler``).

    Reads stderr to EOF itself and reaps the child; a watchdog kills on
    timeout."""
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(extra_env, drop))
    t0 = time.perf_counter()
    rss = RssSampler(proc.pid)
    timed_out = []
    watchdog = threading.Timer(timeout, lambda: (timed_out.append(1),
                                                 proc.kill()))
    watchdog.start()
    try:
        err = proc.stderr.read()
    finally:
        watchdog.cancel()
        peak = rss.stop()
    proc.wait()
    if timed_out:
        return time.perf_counter() - t0, None, "timeout", None
    return time.perf_counter() - t0, proc.returncode, err, peak


class ServeClient:
    """Drives one ``python -m genrich_tpu_torch --serve --device D``
    child: one analysis per line; its stderr goes to ``log``."""

    def __init__(self, cwd, device, log, extra_env=None,
                 ready_timeout=600.0):
        self.log = log
        t0 = time.perf_counter()
        with open(log, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "genrich_tpu_torch", "--serve",
                 "--device", device], cwd=cwd, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True,
                env=_env(extra_env))
        self.rss = RssSampler(self.proc.pid)
        line = self._read_line(ready_timeout)
        if line != "READY":
            raise RuntimeError(f"serve: {line!r}, not READY: "
                               f"{self._tail()}")
        self.ready_s = time.perf_counter() - t0

    def _tail(self):
        with open(self.log) as f:
            return f.read()[-2000:]

    def _read_line(self, timeout):
        import select
        r, _, _ = select.select([self.proc.stdout], [], [], timeout)
        if not r:
            raise TimeoutError("serve: no response")
        return self.proc.stdout.readline().strip()

    def analyze(self, args, timeout):
        """-> (wall_s, perf dict of the ``OK <wall> <json>`` line)."""
        t0 = time.perf_counter()
        self.proc.stdin.write(shlex.join(args) + "\n")
        self.proc.stdin.flush()
        line = self._read_line(timeout)
        if not line.startswith("OK"):
            raise RuntimeError(f"serve: {line!r} for {args}: {self._tail()}")
        parts = line.split(None, 2)
        perf = json.loads(parts[2]) if len(parts) > 2 else {}
        return time.perf_counter() - t0, perf

    def close(self, timeout=60.0):
        """Ends the child (killed when it has not exited ``timeout``
        seconds after EXIT); returns its peak RSS in MB over its life
        (``RssSampler``)."""
        try:
            self.proc.stdin.write("EXIT\n")
            self.proc.stdin.close()
        except OSError:
            pass
        peak = self.rss.stop()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        return peak


def _verify_rows(ref_path, out_path, thresh):
    """Row-level device-vs-reference check (threshold-aware), as
    ``scripts/bench_e2e.py`` makes it: matched rows share (chrom, start,
    end); an unmatched row must overlap a peak of the other side or be
    threshold-marginal (its column 9 near ``thresh``).  Records the
    fraction matched and the worst margin of any non-overlapping
    unmatched row (0.0 = none)."""
    ref = open(ref_path).read().splitlines()
    out = open(out_path).read().splitlines()
    key = lambda ln: tuple(ln.split("\t")[:3])  # noqa: E731
    rk = {key(ln): ln for ln in ref}
    ok_ = {key(ln): ln for ln in out}

    def spans(lines):
        return [(f[0], int(f[1]), int(f[2]))
                for f in (ln.split("\t") for ln in lines)]

    def worst_margin(only_keys, src, other_spans):
        worst = 0.0
        for k in only_keys:
            f = src[k].split("\t")
            chrom, s, e, q = f[0], int(f[1]), int(f[2]), float(f[8])
            if any(c == chrom and s < oe and os_ < e
                   for c, os_, oe in other_spans):
                continue
            worst = max(worst, abs(q - thresh))
        return worst

    worst = max(worst_margin(rk.keys() - ok_.keys(), rk, spans(out)),
                worst_margin(ok_.keys() - rk.keys(), ok_, spans(ref)))
    inter = rk.keys() & ok_.keys()
    return {"rows_ref": len(ref), "rows_out": len(out),
            "match_frac": round(len(inter) / max(len(ref), 1), 4),
            "worst_unmatched_margin": round(worst, 4)}


def write_blacklist(path, exact_np, chroms=HG_CHROMS):
    """The ChIP blacklist of ``chip_smoke.py``: ``testing.blacklist_regions``
    from seed 10 on the first two chromosomes (1,000 regions of 1-50 kb
    per 2 Gbp of them), one region from the midpoint of each one's
    strongest peak of the ATAC exact file ``exact_np`` on.  Returns
    the cuts."""
    rows = [ln.split("\t") for ln in open(exact_np).read().splitlines()]
    cut = []
    for name, _ in chroms[:2]:
        mine = [r for r in rows if r[0] == name]
        if mine:
            top = max(mine, key=lambda r: float(r[6]))
            cut.append((name, (int(top[1]) + int(top[2])) // 2))
    n = round(1000 * sum(size for _, size in chroms[:2]) / 2e9)
    regions = testing.blacklist_regions(np.random.RandomState(10),
                                        chroms[:2], n, (1_000, 50_000),
                                        1 << 28, cut=cut)
    testing.write_bed(path, regions)
    return cut


def _stat(xs):
    """Median, each value in order and the spread of a leg's seconds."""
    return {"median_s": _median(xs), "rep_s": xs,
            "spread_pct": _spread_pct(xs)}


def _records(stderr):
    """BAM/SAM records analyzed, summed over the -v stderr's samples."""
    return sum(int(ln.split()[-1]) for ln in stderr.splitlines()
               if "records analyzed" in ln)


def _config_args(name, bams, run_dir):
    """(argv without -o, significance threshold) of configuration
    ``name`` (``CONFIGS``)."""
    t, c, chip = CONFIGS[name]
    args = ["-t", ",".join(bams[k] for k in t.split(","))]
    if c:
        args += ["-c", ",".join(bams[k] for k in c.split(","))]
    if not chip:
        return args + E2E_FLAGS, Q_THRESH
    return args + CHIP_FLAGS + ["-E", os.path.join(run_dir, "blk.bed"),
                                "-e", "chr3"], P_THRESH


def _exact(args, out, run_dir, timeout, extra_env=None):
    """One ``--engine exact -v`` child: (wall, stderr, peak RSS MB)."""
    cmd = [sys.executable, "-m", "genrich_tpu_torch"] + args + [
        "-o", out, "--engine", "exact", "-v"]
    wall, rc, err, rss = _run_rss(cmd, run_dir, timeout, extra_env)
    if rc != 0:
        raise RuntimeError(f"exact engine exit code {rc}: {err[-1500:]}")
    return wall, err, rss


def _same_bytes(paths):
    data = [open(p, "rb").read() for p in paths]
    return all(d == data[0] for d in data)


def e2e_config(name, bams, clients, reps, run_dir, timeout, par_leg):
    """Configuration ``name``: a cold serve line per device engine, then
    ``reps`` paired reps (the exact child, then one serve line of each
    engine), then on request the two-worker parser leg; with every
    check's result under ``checks`` (``ok`` False when one failed)."""
    args, thresh = _config_args(name, bams, run_dir)

    def out(tag):
        return os.path.join(run_dir, f"{name}_{tag}.np")
    res = {"args": shlex.join(args), "thresh": thresh}
    cold = {}
    for eng, client in clients.items():
        cold[eng] = client.analyze(args + ["-o", out(f"{eng}_cold"),
                                           "--engine", eng], timeout)
    ex_t, ex_rss, warm = [], [], {eng: [] for eng in clients}
    err = ""
    for i in range(reps):
        t, err, rss = _exact(args, out(f"exact_{i}"), run_dir, timeout)
        ex_t.append(t)
        ex_rss.append(rss)
        for eng, client in clients.items():
            warm[eng].append(client.analyze(
                args + ["-o", out(f"{eng}_w{i}"), "--engine", eng], timeout))
    res["exact"] = dict(_stat(ex_t), rss_mb=_peak(ex_rss))
    res["records"] = _records(err)
    res["exact_records_per_s"] = res["records"] / res["exact"]["median_s"]
    res["peaks"] = sum(1 for _ in open(out("exact_0")))
    checks = {"exact_repeat_equal": _same_bytes(
        [out(f"exact_{i}") for i in range(reps)])}
    res["paired"] = {}
    for eng in clients:
        walls = [w for w, _ in warm[eng]]
        perfs = [p for _, p in warm[eng]]
        stages = {k: [p.get(k) for p in perfs]
                  for k in ("ingest_s", "device_rep_s", "findpeaks_s")}
        mem = [p.get("max_memory_allocated_by_card")
               for p in [cold[eng][1]] + perfs]
        mem = [max(card) for card in zip(*(m for m in mem if m))]
        res[eng] = dict(_stat(walls), cold_s=cold[eng][0],
                        load_s=cold[eng][0] - _median(walls),
                        cold_stages={k: cold[eng][1].get(k) for k in stages},
                        stages=stages, max_memory_allocated=max(
                            mem, default=None),
                        max_memory_allocated_by_card=mem or None,
                        perf_median_rep=perfs[walls.index(_median(walls))])
        ratios = [t / w for t, w in zip(ex_t, walls)]
        res["paired"][eng] = {"ratio_rep": ratios,
                              "ratio_median": _median(ratios),
                              "ratio_spread_pct": _spread_pct(ratios)}
        rows = _verify_rows(out("exact_0"), out(f"{eng}_cold"), thresh)
        res[eng]["rows"] = rows
        checks[f"{eng}_rows"] = rows["match_frac"] >= 0.99 \
            and rows["worst_unmatched_margin"] <= 0.02
        checks[f"{eng}_cold_equals_warm"] = _same_bytes(
            [out(f"{eng}_cold")] + [out(f"{eng}_w{i}") for i in range(reps)])
    if par_leg:
        par = [_exact(args, out(f"par2_{i}"), run_dir, timeout,
                      {"GENRICH_INGEST_THREADS": "2"})[0]
               for i in range(max(2, reps - 1))]
        res["exact_par2"] = dict(_stat(par), delta_vs_exact_s=_median(par)
                                 - res["exact"]["median_s"])
        checks["par2_equals_exact"] = _same_bytes(
            [out("exact_0")] + [out(f"par2_{i}") for i in range(len(par))])
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


def bench_e2e(bams, configs, reps, device="cuda", engines=ENGINES,
              work=WORK, chroms=HG_CHROMS, timeout=1800.0, par_leg=True):
    """The end-to-end legs of ``configs`` on ``bams`` ({"A", "B", "C":
    path}), ``atac``'s two-worker parser leg with ``par_leg``; returns
    the detail dict's ``e2e`` part (``ok`` False when a check failed)."""
    from .ingest import ensure_native
    native = ensure_native()             # built once, before any child
    run_dir = os.path.join(work, "bench_e2e")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    for path in set(bams.values()):      # the page cache, for every leg
        read_through(path)
    out = {"reps": reps, "device": device, "engines": list(engines),
           "bams": {k: os.path.basename(p) for k, p in bams.items()},
           "genome_bp": sum(size for _, size in chroms),
           "native_ingest": native.get("path"),
           "host": {"cpus": os.cpu_count(), "loadavg": os.getloadavg()},
           "protocol": "per configuration: a cold serve line per device "
                       "engine, then reps paired reps (exact child, then "
                       "one serve line per engine); ratio = exact wall / "
                       "serve wall of the same rep",
           "exact_ratio": "exact / --engine jax on atac (paired); the "
                          "compiled-reference leg of scripts/bench_e2e.py "
                          "is left out: it needs the Genrich sources",
           "configs": {}}
    if any(CONFIGS[c][2] for c in configs):
        exact_np = os.path.join(run_dir, "blk_source_exact.np")
        _exact(_config_args("atac", bams, run_dir)[0], exact_np, run_dir,
               timeout)
        out["blacklist_cut"] = write_blacklist(
            os.path.join(run_dir, "blk.bed"), exact_np, chroms)
    clients = {}
    try:
        for eng in engines:
            # no process group: the sharded engine spans every card
            # the child sees
            clients[eng] = ServeClient(run_dir, device, os.path.join(
                run_dir, f"serve_{eng}.log"), ready_timeout=timeout)
        out["serve_ready_s"] = {e: c.ready_s for e, c in clients.items()}
        for name in configs:
            out["configs"][name] = e2e_config(name, bams, clients, reps,
                                              run_dir, timeout,
                                              par_leg and name == "atac")
    finally:
        for c in clients.values():
            c.close()
    out["ok"] = all(c["ok"] for c in out["configs"].values())
    atac = out["configs"].get("atac", {})
    if "jax" in atac.get("paired", {}):
        out["paired"] = atac["paired"]["jax"]
    for eng in engines:
        if eng in atac:
            out[f"{eng}_s"] = atac[eng]["median_s"]
    return out


# --- scale ladder and ingest overlap ----------------------------------------

# scripts/bench_mem.py's rungs and phase timers, scripts/bench_overlap.py's
MEM_RUNGS = (2_000_000, 10_000_000, 40_000_000, 60_000_000)
OVERLAP_RUNGS = (10_000_000, 40_000_000)
MEM_OUT = os.path.join(WORK, "bench_torch_mem.json")
OVERLAP_OUT = os.path.join(WORK, "bench_torch_overlap.json")
# bench_mem.py's balanced order (ref, exact, exact, ref, ref, exact) with
# three contenders; reps r take its first 3r legs, repeated past 9
MEM_ORDER = ("exact", "jax", "sharded", "sharded", "jax", "exact", "exact",
             "jax", "sharded")
PROF_ENV = {"GENRICH_NATIVE_PROF": "1", "GENRICH_TPU_PROFILE": "1"}
PATH_KERNELS = ("coverage_scan", "tile_stats", "gap_join", "peak_reduce")
SUMMIT_TOL = 1e-4        # a near tie: the two summits' stats this close
PHASE_RES = {
    "records_s": re.compile(r"\[native\] records: ([0-9.]+)s"),
    "dedup_s": re.compile(r"post\(find_dups\): ([0-9.]+)s"),
    "dedup_scatter_s": re.compile(r"of which scatter: ([0-9.]+)s"),
    "pileup_s": re.compile(r"\[profile\] pileup expt: ([0-9.]+)s"),
    "pvalues_s": re.compile(r"\[profile\] p-values: ([0-9.]+)s"),
    "findpeaks_s": re.compile(r"\[profile\] findPeaks: ([0-9.]+)s"),
}
RECORDS_RE = PHASE_RES["records_s"]
DEDUP_RE = PHASE_RES["dedup_s"]
# the variables an overlap leg sets itself
INGEST_VARS = ("GENRICH_INGEST_THREADS", "GENRICH_ABLATE")
REF_NOTE = ("the ref_* legs of scripts/bench_mem.py (the compiled Genrich "
            "reference) wait on the Genrich sources; each rung pairs the "
            "port's --engine exact with its device engines")


def _phases(err):
    """``scripts/bench_mem.py``'s phase split of one exact run's stderr:
    each ``PHASE_RES`` timer summed over its lines, rounded to ms."""
    out = {}
    for key, rx in PHASE_RES.items():
        m = rx.findall(err or "")
        if m:
            out[key] = round(sum(float(x) for x in m), 3)
    return out


def ladder_bam(n_pairs, work=WORK, chroms=HG_CHROMS):
    """``scripts/bench_e2e.py::_bam_path``'s name of the ``n_pairs`` BAM
    (perf_synth's seed 7) in ``work``: the 2M rung's is BAM A."""
    tag = "hg" if tuple(map(tuple, chroms)) == HG_CHROMS \
        else "c%d" % sum(size for _, size in chroms)
    return os.path.abspath(os.path.join(work,
                                        f"atac_e2e_{tag}_{n_pairs}.bam"))


def ladder_bams(rungs, work=WORK, chroms=HG_CHROMS):
    """The rungs' BAMs, each missing one made by perf_synth, all at once;
    {n_pairs: (path, synthesis seconds or None)}."""
    return synth({n: (ladder_bam(n, work, chroms), n, 7) for n in rungs},
                 chroms)


def read_through(path):
    """Reads the file once, for the page cache."""
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass


def host_info():
    """The host's CPU count, load and RAM."""
    return {"cpus": os.cpu_count(), "loadavg": list(os.getloadavg()),
            "ram_gb": os.sysconf("SC_PAGE_SIZE")
            * os.sysconf("SC_PHYS_PAGES") / 1e9}


def mem_order(reps):
    """The legs of ``reps`` reps, ``MEM_ORDER``'s balanced order."""
    return (MEM_ORDER * -(-reps // 3))[:3 * reps]


def paired_ratios(legs):
    """Per device engine the ratios exact wall / engine wall of each
    temporally adjacent (exact, engine) pair of ``legs`` ([(contender,
    wall)], in order), as ``scripts/bench_mem.py`` pairs its legs: an
    exact leg stands for every engine, and a pair is closed when both
    sides have a leg."""
    engines = sorted({c for c, _ in legs} - {"exact"})
    cur = {eng: {} for eng in engines}
    out = {eng: [] for eng in engines}
    for who, t in legs:
        for eng in engines:
            if who in ("exact", eng):
                cur[eng][who] = t
            if len(cur[eng]) == 2:
                out[eng].append(cur[eng]["exact"] / cur[eng][eng])
                cur[eng] = {}
    return out


def _launched(perf, device):
    """Every card's launches of the path's kernels: each at least once
    on every card of the line on a card; none on the CPU, where the
    wrappers run their plain versions."""
    by_card = perf.get("launches_by_card", {})
    if device == "cpu":
        return all(not any(c.values()) for c in by_card.values())
    return bool(by_card) and all(c.get(k, 0) > 0 for c in by_card.values()
                                 for k in PATH_KERNELS)


def summit_check(exact_np, out_np, make_log, tol=SUMMIT_TOL):
    """``testing.check_summits`` of ``out_np`` against ``exact_np``;
    ``make_log()`` writes the exact engine's ``-f`` log and returns its
    path, called only when a matched row's summit differs (the log of a
    large input is gigabytes).  Raises AssertionError; returns
    {"compared", "differ_near_ties"}."""
    exact = open(exact_np).read().splitlines()
    port = open(out_np).read().splitlines()
    want = {tuple(ln.split("\t")[:3]): ln.split("\t")[9] for ln in exact}
    differ = any(want.get(tuple(f[:3]), f[9]) != f[9]
                 for f in (ln.split("\t") for ln in port))
    log = make_log() if differ else os.devnull
    n, ties = testing.check_summits(exact, port, log, tol)
    return {"compared": n, "differ_near_ties": ties}


def _peak(xs):
    """The largest of the values that are not None, else None."""
    return max((x for x in xs if x is not None), default=None)


def _engine_summary(cold, warm, rss, ready_s):
    """One device engine's lines of a rung: walls, stages, device memory
    (the largest of each card over its lines), re-dispatches, host peak
    chromosomes, its child's RSS (MB, how) over its whole life."""
    walls = [w for w, _ in warm]
    perfs = [cold[1]] + [p for _, p in warm]
    mem = [p.get("max_memory_allocated_by_card") for p in perfs]
    mem = [max(card) for card in zip(*(m for m in mem if m))]
    stages = ("ingest_s", "device_rep_s", "findpeaks_s")
    return dict(
        _stat(walls), cold_s=cold[0], ready_s=ready_s,
        cold_stages={k: cold[1].get(k) for k in stages},
        stages={k: [p.get(k) for _, p in warm] for k in stages},
        max_memory_allocated_by_card=mem or None,
        max_memory_allocated=max(mem, default=None), rss_mb=rss,
        peak_redispatch=[p.get("peak_redispatch") for p in perfs],
        host_peak_chroms=[p.get("host_peak_chroms") for p in perfs],
        launches_by_card=[p.get("launches_by_card") for p in perfs],
        perf_median_rep=warm[walls.index(_median(walls))][1])


def mem_rung(n_pairs, bam, reps=3, device="cuda", work=WORK,
             timeout=7200.0, engines=ENGINES):
    """One rung of the ladder on ``bam``: a fresh serve child per device
    engine (its first line the cold run), then the legs of
    ``mem_order(reps)``, the exact ones ``--engine exact -v`` children
    under ``PROF_ENV``.  Returns the rung's dict: ``scripts/bench_mem.py``'s
    keys for the exact side, one dict per engine with its paired ratios
    (``ratio_reps``, their median ``speedup``, ``ratio_spread_pct``), and
    ``checks`` (``ok`` False when one failed, ``faults`` saying why)."""
    run_dir = os.path.abspath(os.path.join(work, "bench_mem", str(n_pairs)))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    read_through(bam)
    args = ["-t", os.path.abspath(bam)] + E2E_FLAGS

    def out(tag):
        return os.path.join(run_dir, f"{tag}.np")
    res = {"n_pairs": n_pairs, "bam": os.path.basename(bam),
           "bam_mb": os.path.getsize(bam) / 1e6, "order": mem_order(reps)}
    clients, rss, cold = {}, {}, {}
    warm = {eng: [] for eng in engines}
    legs, ex_t, ex_rss, phase_reps = [], [], [], []
    err = ""
    try:
        for eng in engines:
            clients[eng] = ServeClient(run_dir, device, os.path.join(
                run_dir, f"serve_{eng}.log"), ready_timeout=timeout)
            cold[eng] = clients[eng].analyze(
                args + ["-o", out(f"{eng}_cold"), "--engine", eng], timeout)
        for who in res["order"]:
            if who == "exact":
                t, err, r = _exact(args, out(f"exact_{len(ex_t)}"), run_dir,
                                   timeout, PROF_ENV)
                ex_t.append(t)
                ex_rss.append(r)
                phase_reps.append(_phases(err))
            elif who in clients:
                t, perf = clients[who].analyze(args + [
                    "-o", out(f"{who}_w{len(warm[who])}"), "--engine", who],
                    timeout)
                warm[who].append((t, perf))
            else:
                continue
            legs.append((who, t))
    finally:
        for eng, c in clients.items():
            rss[eng] = c.close()
    res.update(exact_rep_s=ex_t, exact_s=_median(ex_t),
               exact_rss_mb=_peak(ex_rss),
               records=_records(err),
               peaks=sum(1 for _ in open(out("exact_0"))))
    keys = sorted({k for p in phase_reps for k in p})
    res["exact_phases"] = {k: _median([p[k] for p in phase_reps if k in p])
                           for k in keys}
    res["exact_phase_reps"] = phase_reps
    res["exact_rec_per_s"] = res["records"] / res["exact_s"]
    res["exact_us_per_rec"] = 1e6 * res["exact_s"] / res["records"]
    checks = {"exact_repeat_equal": _same_bytes(
        [out(f"exact_{i}") for i in range(len(ex_t))])}
    faults = {}
    log = []

    def make_log():
        if not log:
            log.append(os.path.join(run_dir, "exact.log"))
            _exact(args + ["-f", log[0]], out("exact_log"), run_dir,
                   timeout)
        return log[0]
    ratios = paired_ratios(legs)
    for eng in engines:
        e = res[eng] = _engine_summary(cold[eng], warm[eng], rss[eng],
                                       clients[eng].ready_s)
        pairs = ratios[eng]
        e.update(ratio_reps=pairs, speedup=_median(pairs),
                 ratio_spread_pct=_spread_pct(pairs))
        outs = [out(f"{eng}_cold")] + [out(f"{eng}_w{i}")
                                       for i in range(len(warm[eng]))]
        e["rows"] = _verify_rows(out("exact_0"), outs[0], Q_THRESH)
        checks[f"{eng}_rows"] = e["rows"]["match_frac"] >= 0.99 \
            and e["rows"]["worst_unmatched_margin"] <= 0.02
        try:
            e["summits"] = summit_check(out("exact_0"), outs[0], make_log)
            checks[f"{eng}_summits"] = True
        except AssertionError as x:
            checks[f"{eng}_summits"] = False
            faults[f"{eng}_summits"] = str(x)[:1000]
        checks[f"{eng}_cold_equals_warm"] = _same_bytes(outs)
        checks[f"{eng}_no_host_peak_chroms"] = not any(e["host_peak_chroms"])
        checks[f"{eng}_kernels_launched"] = all(
            _launched(p, device) for p in [cold[eng][1]]
            + [p for _, p in warm[eng]])
    res["exact_log_written"] = bool(log)
    res["checks"] = checks
    res["faults"] = faults
    res["ok"] = all(checks.values())
    return res


def mem_ladder(rungs=MEM_RUNGS, reps=3, device="cuda", work=WORK,
               chroms=HG_CHROMS, timeout=7200.0, out_path=None):
    """``scripts/bench_mem.py`` on the port: every rung's BAM made first
    (all missing ones at once), then ``mem_rung`` for each; the detail
    written to ``out_path`` after every rung.  Returns the dict with the
    script's top-level keys (``flags``, ``host``, ``ladder``), the card
    and ``ok``."""
    from .ingest import ensure_native
    native = ensure_native()             # built once, before any child
    if device == "cuda":
        from . import kernels
        kernels.library()                # so no cold line includes nvcc
    bams = ladder_bams(rungs, work, chroms)
    out = {"flags": " ".join(E2E_FLAGS), "host": host_info(),
           "card": card_line(torch.device(device)), "reps": reps,
           "device": device, "native_ingest": native.get("path"),
           "genome_bp": sum(size for _, size in chroms),
           "synth_s": {str(n): s for n, (_, s) in bams.items()},
           "note": REF_NOTE, "ladder": []}
    for n in rungs:
        out["ladder"].append(mem_rung(n, bams[n][0], reps, device, work,
                                      timeout))
        out["ok"] = all(r["ok"] for r in out["ladder"])
        out["bench_process_maxrss_mb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0
        if out_path:
            _write(out_path, out)
    return out


def compact_ladder(out):
    """The last stdout line of ``--mem``: the detail's rungs cut to
    ``scripts/bench_mem.py``'s keys and each engine's headline."""
    rungs = []
    for r in out["ladder"]:
        keep = {k: r[k] for k in (
            "n_pairs", "records", "peaks", "exact_rep_s", "exact_s",
            "exact_rss_mb", "exact_phases", "exact_rec_per_s",
            "exact_us_per_rec", "ok")}
        for eng in ENGINES:
            if eng in r:
                e = r[eng]
                keep[eng] = {
                    "warm_s": e["median_s"], "rep_s": e["rep_s"],
                    "cold_s": e["cold_s"], "ratio_reps": e["ratio_reps"],
                    "speedup": e["speedup"],
                    "ratio_spread_pct": e["ratio_spread_pct"],
                    "rss_mb": e["rss_mb"],
                    "max_memory_allocated": e["max_memory_allocated"],
                    "stages_median": {k: _median(v) for k, v in
                                      e["stages"].items() if None not in v}}
        keep["failed"] = [k for k, v in r["checks"].items() if not v]
        rungs.append(keep)
    return {k: out[k] for k in ("flags", "host", "card", "note", "ok")} \
        | {"ladder": rungs}


def overlap_leg(args, run_dir, tag, env, reps, timeout, ablate=None):
    """``scripts/bench_overlap.py``'s ``_leg`` on the port's exact engine:
    ``reps`` runs under ``GENRICH_NATIVE_PROF=1`` and ``env``, the
    ingest variables not in ``env`` unset.  Every run must print the
    record and dedup timers (one line of the native ingest); an ablated
    run's exit code is ignored (its records loop makes no fragments).
    Returns the walls, the median records and dedup timers, and the
    outputs written."""
    env = {"GENRICH_NATIVE_PROF": "1", **env}
    if ablate:
        env["GENRICH_ABLATE"] = ablate
    drop = [v for v in INGEST_VARS if v not in env]
    walls, recs, deds, outs = [], [], [], []
    for i in range(reps):
        o = os.path.join(run_dir, f"{tag}_{i}.np")
        cmd = [sys.executable, "-m", "genrich_tpu_torch"] + args + [
            "-o", o, "--engine", "exact"]
        t, rc, err, _ = _run_rss(cmd, run_dir, timeout, env, drop)
        if not ablate and rc != 0:
            raise RuntimeError(f"overlap {tag}: exit code {rc}: "
                               f"{(err or '')[-400:]}")
        if not ablate:
            outs.append(o)
        walls.append(t)
        for rx, got in ((RECORDS_RE, recs), (DEDUP_RE, deds)):
            m = rx.search(err or "")
            if not m:
                raise RuntimeError(f"overlap {tag}: no {rx.pattern} "
                                   f"timer: {(err or '')[-400:]}")
            got.append(float(m.group(1)))
    return {"wall_s": _median(walls), "wall_rep_s": walls, "outputs": outs,
            "records_s": _median(recs), "dedup_s": _median(deds)}


def default_workers(cpus):
    """The record-parse workers ``native/ingest.cpp::parse_threads``
    starts with GENRICH_INGEST_THREADS unset: cores - 2, at most 16, on
    4 cores or more, else none (sequential)."""
    return 0 if cpus < 4 else min(cpus - 2, 16)


def overlap_rung(n_pairs, bam, work=WORK, timeout=3600.0):
    """One rung of ``scripts/bench_overlap.py``: seq, par2, par2, seq
    (A-B-B-A, as the script), then the ``default`` leg (the variable
    unset: ``default_workers`` of this host), twice, and ``frame_only``
    (inflate and framing alone); the script's ``par2_gain_pct`` and
    ``records_minus_frame_s``, and ``default_gain_pct``.  Checks that
    every par2 and default output is seq's bytes."""
    run_dir = os.path.abspath(os.path.join(work, "bench_overlap",
                                           str(n_pairs)))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    read_through(bam)
    args = ["-t", os.path.abspath(bam)] + E2E_FLAGS
    seq_env = {"GENRICH_INGEST_THREADS": "0"}
    s1 = overlap_leg(args, run_dir, "seq_a", seq_env, 1, timeout)
    p = overlap_leg(args, run_dir, "par2", {"GENRICH_INGEST_THREADS": "2"},
                    2, timeout)
    s2 = overlap_leg(args, run_dir, "seq_b", seq_env, 1, timeout)
    d = overlap_leg(args, run_dir, "default", {}, 2, timeout)
    frame = overlap_leg(args, run_dir, "frame_only", seq_env, 1, timeout,
                        ablate="frame")
    seq = {"wall_s": _median([s1["wall_s"], s2["wall_s"]]),
           "records_s": _median([s1["records_s"], s2["records_s"]]),
           "dedup_s": _median([s1["dedup_s"], s2["dedup_s"]]),
           "wall_rep_s": s1["wall_rep_s"] + s2["wall_rep_s"],
           "outputs": s1["outputs"] + s2["outputs"]}
    legs = {"seq": seq, "par2": p, "default": d, "frame_only": frame}
    checks = {"seq_repeat_equal": _same_bytes(seq["outputs"]),
              **{f"{k}_equals_seq": _same_bytes(seq["outputs"][:1]
                                                + legs[k]["outputs"])
                 for k in ("par2", "default")}}
    cpus = os.cpu_count()
    res = {"n_pairs": n_pairs, "cpus": cpus,
           "default_workers": default_workers(cpus),
           "order": ["seq", "par2", "par2", "seq", "default", "default",
                     "frame_only"],
           **{k: {x: v for x, v in leg.items() if x != "outputs"}
              for k, leg in legs.items()},
           "par2_gain_pct": 100.0 * (seq["wall_s"] - p["wall_s"])
           / seq["wall_s"],
           "default_gain_pct": 100.0 * (seq["wall_s"] - d["wall_s"])
           / seq["wall_s"],
           "records_minus_frame_s": seq["records_s"]
           - frame["records_s"],
           "checks": checks, "ok": all(checks.values())}
    return res


def overlap(rungs=OVERLAP_RUNGS, work=WORK, chroms=HG_CHROMS,
            timeout=3600.0, out_path=None):
    """``scripts/bench_overlap.py`` on the port: ``overlap_rung`` for each
    rung (the BAMs made first); the detail written after every rung."""
    from .ingest import ensure_native
    native = ensure_native()
    bams = ladder_bams(rungs, work, chroms)
    out = {"flags": " ".join(E2E_FLAGS), "host": host_info(),
           "native_ingest": native.get("path"), "rungs": []}
    for n in rungs:
        out["rungs"].append(overlap_rung(n, bams[n][0], work, timeout))
        out["ok"] = all(r["ok"] for r in out["rungs"])
        if out_path:
            _write(out_path, out)
    return out


# --- output -----------------------------------------------------------------

def compact_headline(out):
    """The last stdout line: ``bench.py``'s keys and the card's name and
    power limit, well under 1,500 characters whatever the detail holds."""
    e2e = out.get("e2e", {})
    e2e = e2e if isinstance(e2e, dict) else {}
    paired = e2e.get("paired", {})
    return {
        "metric": out["metric"], "value": out["value"], "unit": out["unit"],
        "vs_baseline": out["vs_baseline"],
        "prod_pos_per_sec": out["kernel_production"]["positions_per_sec"],
        "prod_vs_baseline": out["kernel_production"]["vs_baseline"],
        "roofline_frac_ideal":
            out["kernel"]["roofline"]["frac_vs_ideal_sort"],
        "roofline_frac_ideal_prod":
            out["kernel_production"]["roofline"]["frac_vs_ideal_sort"],
        "e2e_exact_ratio": paired.get("ratio_median"),
        "e2e_ratio_spread_pct": paired.get("ratio_spread_pct"),
        "e2e_jax_warm_s": e2e.get("jax_s"),
        "e2e_sharded_warm_s": e2e.get("sharded_s"),
        "detail": out.get("detail"),
        "device": out.get("device"),
    }


def card_line(device):
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _write(path, out):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m genrich_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kernel-only", action="store_true",
                    help="the kernel legs alone")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="end-to-end configurations, comma-separated")
    ap.add_argument("--reps", type=int, help="reps of every leg (default: "
                    f"{REPS} light, {PROD_REPS} production, "
                    "GENRICH_BENCH_E2E_REPS or 3 end to end)")
    ap.add_argument("--scaling", action="store_true",
                    help="the scaling leg alone (scripts/bench_scaling.py's "
                    "measure over 1-8 shards a form); its JSON is the last "
                    "line")
    ap.add_argument("--mem", nargs="*", type=int, metavar="N",
                    help="the scale ladder alone (scripts/bench_mem.py's "
                    "measure) at N read pairs a rung (default: "
                    f"{' '.join(map(str, MEM_RUNGS))}); its JSON is the "
                    "last line")
    ap.add_argument("--overlap", nargs="*", type=int, metavar="N",
                    help="the ingest-overlap legs alone "
                    "(scripts/bench_overlap.py's measure) at N read pairs a "
                    f"rung (default: {' '.join(map(str, OVERLAP_RUNGS))}); "
                    "its JSON is the last line")
    ap.add_argument("--out", help=f"the detail JSON (default: {DETAIL}, "
                    f"with --scaling {SCALING_OUT}, --mem {MEM_OUT}, "
                    f"--overlap {OVERLAP_OUT})")
    a = ap.parse_args(argv)
    configs = [c for c in a.configs.split(",") if c]
    bad = [c for c in configs if c not in CONFIGS]
    if bad:
        ap.error(f"unknown configurations {bad}; known: {list(CONFIGS)}")
    device = torch.device(a.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA card "
                             "(torch.cuda.is_available() is False)")
        device = torch.device("cuda", 0)
    if a.scaling:
        out = scaling(device, reps=a.reps or SCALING_REPS)
        _write(a.out or SCALING_OUT, out)
        print(json.dumps(out))
        return 0
    if a.mem is not None:
        out = mem_ladder(a.mem or MEM_RUNGS, a.reps or 3, a.device,
                         out_path=a.out or MEM_OUT)
        print(json.dumps(compact_ladder(out)))
        return 0 if out["ok"] else 1
    if a.overlap is not None:
        out = overlap(a.overlap or OVERLAP_RUNGS, out_path=a.out or OVERLAP_OUT)
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    t0 = time.perf_counter()
    out = kernel_legs(device, reps=a.reps or REPS,
                      prod_reps=a.reps or PROD_REPS)
    out["device"] = card_line(device)
    out["detail"] = a.out or DETAIL
    ok = True
    if not a.kernel_only:
        reps = a.reps or int(os.environ.get("GENRICH_BENCH_E2E_REPS", "3"))
        keys = sorted({k for c in configs for side in CONFIGS[c][:2]
                       for k in side.split(",") if k} | {"A"})
        out["e2e"] = bench_e2e(make_bams(keys), configs, reps, a.device)
        ok = out["e2e"]["ok"]
    out["seconds"] = time.perf_counter() - t0
    _write(out["detail"], out)
    k = out["kernel"]
    print(f"# {k['dispatches']}x{k['batch']} tiles x {k['events_per_tile']} "
          f"events, median {k['median_s']:.3f} s over {len(k['rep_s'])} "
          f"reps (spread {k['spread_pct']:.1f}%), {out['device']}, "
          f"{out['seconds']:.0f} s", file=sys.stderr)
    if not ok:
        failed = {n: [c for c, v in r["checks"].items() if not v]
                  for n, r in out["e2e"]["configs"].items() if not r["ok"]}
        print(f"# FAILED checks: {failed}", file=sys.stderr)
    print(json.dumps(compact_headline(out)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genrich_tpu_torch) on one card.

    python3 chip_smoke.py [--phase sharded_cards|sharded_ranks|ladder]

It needs one card; phases 14 and 15 span every card the machine has.

Phases, each printed on its own line; any failure raises and exits
non-zero, and the result line is printed only when every phase passed:

1. Card: name, nvidia-smi power limit; no CUDA card is an error.
2. Build: the port's ``ingest.ensure_native()`` builds the port's own
   genrich_tpu_torch/native/ingest.cpp with its Makefile into the
   git-ignored genrich_tpu_torch/_build/ (named by a hash of the two
   files) and loads it, then nvcc builds genrich_tpu_torch/csrc there
   (one process per source, all at once), and csrc/reference (the first
   designs of K1-K5, which the port never loads); the ingest library's
   path, source hash, build seconds and whether it has libdeflate are
   printed, and a library from anywhere but _build/ fails the phase.
   At the end, a file under the repo's native/ (the JAX package's
   library) mapped into this process fails the smoke.
3. Kernels: each hand-written kernel against its plain PyTorch version
   and its first design on the card: coverage_scan (K1, 2^23 rows and a
   ragged size, with carries) bitwise in both modes and bitwise to its
   first design (-log10 p of the lambda mode rtol = atol = 1e-5),
   tile_stats (K2) rtol = atol = 1e-5 and bitwise to its first design,
   fisher_combine (K3, R = 2 and 3, 2^23 lanes and a ragged size, 10%
   SKIP) rtol 1e-6 against the float64 plain version with SKIP lanes
   identical and bitwise to its first design; median times with CUDA
   events.  The BAMs of phases 4-12 are synthesised by
   genrich_tpu_torch/tools/perf_synth.py (the port's copy of
   scripts/perf_synth.py) into the git-ignored .bench_cache/ when
   missing, one child process each, all started before the build and
   awaited before this phase.
4. Main path: the 2M-pair ATAC BAM on the 2.75 Gbp human-scale genome
   of scripts/bench_e2e.py, the port's ``--engine exact -v`` once in
   this process (host code only; tests/test_torch_exact.py holds its
   bytes to the JAX package's exact engine on every flag set), writing
   an -f log too: its wall and each output's md5 printed, the oracle of
   every device run.  Then the port twice in this process (cold, warm)
   with ``-r -j -q 0.05 -a 20 --device cuda``.  Checks: K1, K2, K5 and K4 launched in
   each run, the fragment sums, lambda and factor each device run
   takes beside the port's exact engine's (equal: every term of these
   BAMs is an integer), native ingest in every run, the peak rows
   against the exact engine by bench_e2e's rule (match_frac >= 0.99,
   worst_unmatched_margin <= 0.02), column 10 (summit offset) of every
   matched row equal to the exact engine's or a near tie that its -f log
   shows (``testing.check_summits``, stats within SUMMIT_TOL), cold and
   warm narrowPeak byte-identical; the interval rows before and after
   the engine merged them into the exact engine's intervals
   (``compact.pileup_runs``) are printed.  One more run keeps the inputs
   of the main path's own K1, merge, K2, K5 and K4 calls.  The merge (plain
   PyTorch, no kernel) on them: every output on the card bitwise to the
   same code on the CPU, times.  Every kernel on its path's calls
   launches the device kernels
   of ``kernels.KERNELS_PER_CALL`` per call (the call captured into a
   CUDA graph, whose kernel nodes are read), the table ``prof.py``
   holds torch.profiler's records to.  K1 on them: bitwise to its plain
   version and its first design (a call whose carry is zero also with
   a non-zero one), times; K2 on them against its plain version (rtol
   = atol = 1e-5) and its first design (bitwise), times, and the rows
   it read from its tables (branches ``table_p`` and
   ``table_params``).  K4 on them and on 2^23 synthetic rows holding
   about 30,000 short peaks: against its plain version (summit fields
   exact, AUC rtol 1e-5), against the exact engine's float32 row-order
   sum (AUC bitwise), and all six outputs bitwise to its first
   design.  K5 (the gap-join) on them and on 2^23 synthetic rows
   (``testing.gap_join_rows``) holding far more peaks than the 4,096
   slots: every output bitwise to its plain version and its first
   design (``csrc/reference/gapjoin_first.cu``), twice in a row, one
   kernel and no memset per call, times beside the first design's.
5. Control: ``-t A -c B`` (B the second 2M-pair BAM, seed 8), the
   same flags; the exact engine once, the port cold and warm, the
   same checks as the main path.  One more run keeps the inputs of its
   merge, K2, K5 and K4 calls (its K2 calls are the only ones where
   the control varies from row to row): each on them as on the main
   path's.
6. Fisher: ``-t A,B``, the same flags; the exact engine once, the
   port cold and warm.  Checks: the same row rule, cold == warm bytes,
   K1 and K2 launched 6 times, K3 3 times, K4 and K5 at least 3 times
   per run.  One more run keeps the inputs of its K3 and K5 calls: K3
   on them against its float64 plain version and its first design
   (bitwise), K5 as on the main path's, times.
7. Sharded main path: the main path's BAM and flags with ``--engine
   sharded`` under a one-rank NCCL process group (MASTER_ADDR,
   MASTER_PORT, RANK=0, WORLD_SIZE=1 set for the phase and the group
   made from them before its runs, so the collectives run through NCCL
   on the card), cold and warm, against
   phase 4's exact file.  Prints the grid (2^28-bp tiles, 5 per
   chromosome), the merged peaks that straddle a tile boundary and the
   chromosomes the host peak caller finished.  Checks: K1, K2, K5 and K4
   launched in each run, the row rule, the summits, cold == warm bytes.
   One more run keeps the inputs of its K1, merge (one call per tile),
   K2, K5 and K4 calls; the merge and K5 (one call per tile) as on the
   main path's.  K1 (one call per
   tile, each from its carry): bitwise to its plain version and its
   first design, one kernel per call, times; every carry of this BAM is
   zero (all its weights are whole), so each call is held once more
   with a non-zero carry.  K2 (one call per chromosome over its tiles
   flattened, padding rows included) as on the main path's calls.  K4
   (one call per tile, the tiles past a chromosome's end among them) as
   on the main path's calls.
8. Sharded Fisher: ``-t A,B --engine sharded`` under the same group,
   cold and warm, against phase 6's exact files by the same rules (each
   straddling peak's summit taken again over its rows, the tiles'
   ``cont`` from each replicate's runs); K3 launched; cold == warm.
   One more run keeps the inputs of its K3 and K5 calls (one per tile,
   K3's RLEs padded with (limit, SKIP) rows): each on them as on the
   Fisher path's calls.
9. Serve: a child ``python -m genrich_tpu_torch --serve --device cuda``
   fed ``--engine jax`` twice, ``--engine sharded`` twice, a bogus line,
   ``--engine jax`` again and ``--engine exact``, on the main path's
   BAM and flags.  Statuses OK OK OK OK ERR OK OK; each engine's warm
   file equals its cold one and the in-process run of the same engine
   (phases 4 and 7; the exact line's, the exact file of phase 4);
   every device line's JSON has ingest_s, upload_bytes, dispatch_n
   and fetch_s, the exact line's ingest_s and findpeaks_s; the walls,
   cold beside warm.
10. Logs (depth cut to a 200,000-pair BAM: every log row is text on
   both sides): ``-f f.log -k k.log`` with the same flags; the exact
   engine once (each output's md5 printed), then the port on the card
   against the exact logs by ``testing.check_log``.
11. ChIP-seq: Genrich's ChIP flags (no -j, ``-r -p 0.01 -a 20 -E
   blk.bed -e chr3``; chr3 stands in for chrM), the blacklist written
   by ``testing.blacklist_regions`` (seed 10: 1,000 regions of 1-50 kb
   on chr1 and chr2, overlapping and adjacent pairs, one across each
   2^28-bp tile boundary, one at chr1's end, one from the midpoint of
   the strongest main-path peak of chr1 and of chr2 on).  ``chip``:
   ``-t A -c B``, the exact engine's md5s printed, an exact peak
   ending at each cut, TorchEngine cold and warm by the gates of phase
   4, then K1, the merge, K2 (on rows with excluded flags; none is a
   fault), K5 and K4 on its own calls.  ``chip_fisher``: ``-t A,B -c
   C,C`` (C a third BAM, 1M pairs, seed 9), the port's exact engine
   alone the oracle, then K1, the merge, K2 (excluded rows again
   required), K3 over the controlled replicates, K5 and K4 on its own
   calls.  ``chip_capped``:
   the chip run once more with TorchEngine's PEAK_CAP set to 256: the
   bytes of the uncapped run, no chromosome on the host peak caller, at
   least one re-dispatch, every K5 and K4 call counted and the
   re-dispatched ones held to their plain versions with their kernels
   read by graph capture.
12. The same three runs with ``--engine sharded`` under a one-rank NCCL
   group (the capped one with 64 slots a tile).  No path may send a
   chromosome to the host peak caller (``host_peak_chroms``).
13. Bench: ``python -m genrich_tpu_torch.bench --kernel-only --reps 1``
   in this process (its light and production kernel legs at
   ``bench.py``'s shapes; every launch counted as the ``bench`` path,
   K1, K2, K5 and K4 each at least once), then one light tile (K1 in
   lambda mode, K5, K4) and one production tile (K1, K2, K5, K4) of it
   again with their kernels' inputs kept: K1's coverage bitwise to its
   plain version and its lambda-mode -log10 p within rtol = atol =
   1e-5, each kernel held and timed on those calls as on the main
   path's (kernels per call by graph capture), and each tile's peaks
   equal to the same tile's through the plain versions on the CPU; then
   the bench's ``atac`` end-to-end leg, one rep, ``--engine jax`` (its
   serve output must be the main path's bytes).  Its seconds are
   printed.
14. Sharded over the cards (``sharded_cards``): ``--engine sharded
   --device cuda`` with no process group, spanning every card of the
   machine, cold and warm, then once over two contexts on cuda:0 (so a
   one-card machine still drives the in-process collectives), on the
   main path's BAM and flags and on ``chip_fisher``: each output the
   recorded md5 (main 1e5d8a67..., chip_fisher 2aa2ffba...) and the
   bytes of TorchEngine and of the one-card sharded engine (phases 4,
   7, 11 and 12), no chromosome on the host peak caller, K1, K2, K5 and
   K4 (and K3 on chip_fisher) launched on every card
   (``kernels.CARD_LAUNCHES``, the counts set to 0 just before each
   run and read just after); the card count, each run's wall and each
   card's peak memory printed.  ``python3 chip_smoke.py --phase
   sharded_cards`` runs phase 1, the build, the BAMs and this phase
   alone (making its one-card references on cuda:0), with no result
   line.
15. Several shards a rank (``sharded_ranks``), on the main path's BAM
   and flags and on ``chip_fisher``: one NCCL rank of two contexts on
   cuda:0 (``ShardedTorchEngine(["cuda:0", "cuda:0"])`` under a
   one-rank group), and on a machine of two cards or more two NCCL rank
   children, cold and warm: on four cards or more (an even count) the
   CLI with ``--engine sharded --device cuda``, ``LOCAL_WORLD_SIZE=2``
   and ``LOCAL_RANK=r`` (half the cards a rank), otherwise
   ``ShardedTorchEngine([f"cuda:{r}"] * 2)`` through ``pipeline.run``;
   the main path once more under torch.profiler (device ms a card, and
   of it NCCL's kernels, copies between cards and copies on a card).
   The gates of phase 14 on every output of every rank (the recorded
   md5, TorchEngine's and the one-card sharded engine's bytes, no host
   peak call, K1, K2, K5 and K4, and K3 on ``chip_fisher``, on every
   card of every rank, each child reporting its
   ``kernels.CARD_LAUNCHES``); no child imports jax or genrich_tpu, and
   a child that exits non-zero fails the phase.  Printed: cards, ranks,
   shards a rank, each run's wall, ``device_rep_s`` and peak memory a
   card.  Then ``python -m genrich_tpu_torch --engine sharded --device
   cuda`` itself as NCCL rank processes, on both paths: one rank
   (``WORLD_SIZE=1``) on any machine, and two ranks of one card each on
   two cards or more; the CLI joins the group and leaves it.  Each rank
   must exit with 0, with no abort, "has NOT been destroyed", fatal
   error or traceback in its output, and write the one-card bytes.
   Printed: the exit codes, each rank's wall and its teardown (its
   narrowPeak's mtime to its exit), and, in this process, the wall of
   leaving a one-rank group (barrier and destroy), 5 times.  ``python3
   chip_smoke.py --phase sharded_ranks`` runs phase 1, the build, the
   BAMs and this phase alone, with no result line.
16. The ladder (``ladder``): the 10M-pair rung of ``python -m
   genrich_tpu_torch.bench --mem`` (perf_synth's seed 7 on the 2.75 Gbp
   genome, ``-r -j -q 0.05 -a 20``; its BAM synthesised by a child
   process started with the others, about 513 s, while phases 2-15
   run): ``bench.mem_rung`` with one rep, the port's ``--engine exact
   -v`` child (the oracle) and a serve child per device engine (no
   process group) with a cold and a warm line, and every check of the
   bench's rung: the rows against the exact output, the summits
   (``testing.check_summits``; the exact engine's -f log written only
   when a summit differs), cold == warm bytes, no chromosome on the host
   peak caller, K1, K2, K5 and K4 launched on every card in every line
   (each serve line's ``launches_by_card``, its counts set to 0 just
   before the analysis and read just after).  Printed: the walls, the
   stage seconds, ``max_memory_allocated_by_card`` and each child's
   host RSS.  Then one more TorchEngine run in this process keeps the
   inputs of the largest chromosome's own K1, K2, K5 and K4 calls: K1
   bitwise to its plain version, K2 within rtol = atol = 1e-5 (its rows
   read from its tables and beyond them printed; the 10M call stays
   below the tables, so K2 is held again on the call with every 40th
   row's coverage raised to an integral value of 8,192 to 33,290), K5
   bitwise, K4 with its summit fields exact and its AUC bitwise to the
   row-order sum (each also bitwise to its first design, as on the main
   path), each call's rows and device ms printed.  ``python3 chip_smoke.py --phase
   ladder`` runs phase 1, the build, its BAM and this phase alone, with
   no result line.
17. The last lines: the kernels JSON (``launches_by_path`` with the
   ChIP paths, the bench, ``sharded_cards``, ``sharded_ranks``,
   ``ladder`` and ``ladder_sharded``, each
   kernel's sums on
   them under ``<path>_path``, K1's lambda mode on the bench's light tile under
   ``lambda_mode.bench_path``), the
   nvidia-smi line and {"ok": true, "device": {...}}; neither jax nor
   genrich_tpu is ever imported in this process.  Each kernel's bound
   is the larger of its bytes (each input read once, each output
   written once) over 3.35 TB/s and
   its operations over the peak of their unit (67 TFLOP/s float32, 34
   TFLOP/s float64), the operations counted on the same inputs by
   ``testing``'s counters (``bound_by`` says which term binds; the
   entry carries ``bytes``, ``fp32_ops`` and ``fp64_ops``); its
   ``launches`` are those of the main path (the Fisher path's for K3),
   and ``launches_by_path`` gives every path's.  K5's entry
   (``gap_join``) adds its control, Fisher, sharded and sharded Fisher
   calls' sums and the synthetic rows'.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench_cache")
N_PAIRS = 2_000_000
N_LOG_PAIRS = 200_000
FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]   # bench_e2e.FLAGS
Q_THRESH = 1.3010299956639813                     # -log10(0.05)
M_MAIN = 1 << 23
M_RAGGED = (1 << 23) - 12_345
TOL = 1e-5
FISHER_RTOL = 1e-6
SUMMIT_TOL = 1e-4        # a near tie: the two summits' stats this close
CARRY8 = [5, 1, 2, 3, 7, 0, 1, 4]   # a carry into K1's scan (G=2)
PEAKS_K4 = 30_000
DEV = "cuda"
SM_CLOCK_HZ = 1.98e9           # H100 SXM boost clock (data sheet)
FADD_CYCLES = 4                # dependent float32 add latency
BUSY_CYCLES = 2_000_000        # about 1 ms of spinning ahead of a timing
N_LADDER = 10_000_000   # phase 16: the second rung of bench --mem
# (pairs, seed) of each BAM: main path / Fisher replicate A, Fisher
# replicate B, logs, the control of the ChIP Fisher replicates, and the
# ladder's rung (bench.ladder_bam's name)
BAMS = {"a": (N_PAIRS, 7), "b": (N_PAIRS, 8), "log": (N_LOG_PAIRS, 7),
        "c": (N_PAIRS // 2, 9), "ladder": (N_LADDER, 7)}


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


SYNTH = {}       # key -> (child process, start) of a BAM being made


def _bam_path(key: str) -> str:
    n, seed = BAMS[key]
    tag = "" if seed == 7 else f"_seed{seed}"
    return os.path.join(WORK, f"atac_e2e_hg_{n}{tag}.bam")


def start_synth(keys):
    """Start genrich_tpu_torch/tools/perf_synth.py (``bench._SYNTH``) for
    every BAM of ``keys`` (of ``BAMS``) missing from .bench_cache/, one
    child process each, all at once (about 40 s for 2M pairs; one after
    the other they took 105 s; the ladder's 10M pairs take about 513 s,
    while phases 2-15 run)."""
    from genrich_tpu_torch import bench
    os.makedirs(WORK, exist_ok=True)
    for key in keys:
        n, seed = BAMS[key]
        path = _bam_path(key)
        if not os.path.exists(path):
            SYNTH[key] = (subprocess.Popen(
                [sys.executable, "-c", bench._SYNTH, REPO, path + ".tmp",
                 str(n), str(seed), json.dumps(bench.HG_CHROMS)],
                stdout=subprocess.DEVNULL),
                time.perf_counter())


def stop_synth():
    for proc, _ in SYNTH.values():
        proc.kill()
        proc.wait()
    SYNTH.clear()


def synth_bam(key: str) -> str:
    """The BAM of ``BAMS[key]`` in .bench_cache/, waiting for its
    ``start_synth`` child if it is still being made."""
    path = _bam_path(key)
    if key in SYNTH:
        proc, t0 = SYNTH.pop(key)
        if proc.wait() != 0:
            raise AssertionError(f"perf_synth of BAM {key}: exit code "
                                 f"{proc.returncode}")
        os.replace(path + ".tmp", path)
        n, seed = BAMS[key]
        say("synth", bam=key, pairs=n, seed=seed,
            seconds=time.perf_counter() - t0,
            mb=os.path.getsize(path) / 1e6)
    return path


# --- build ----------------------------------------------------------------

def build():
    """Native ingest, the kernels and their first designs; returns the
    native ingest library's path, which must lie in the port's _build/."""
    from genrich_tpu_torch import kernels
    from genrich_tpu_torch.ingest import native
    t0 = time.perf_counter()
    nat_info = dict(native.ensure_native())
    if os.path.dirname(nat_info["path"]) != str(kernels.BUILD_DIR):
        raise AssertionError(f"native ingest loaded from {nat_info['path']}"
                             f", not from {kernels.BUILD_DIR}")
    kernels.library()
    info = dict(kernels.BUILD_INFO)
    ptxas = info.pop("ptxas", "")
    info["nvcc_seconds"] = info.pop("seconds")
    t1 = time.perf_counter()
    kernels.reference_library()
    say("build", wall_s=time.perf_counter() - t0, **info,
        reference_nvcc_seconds=time.perf_counter() - t1,
        native_ingest=nat_info)
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print("  ptxas:", line.strip())
    return nat_info["path"]


# --- kernels against their plain versions ---------------------------------

def _median_ms(fn, n=20, busy=True):
    """Median milliseconds of ``fn`` between two CUDA events
    (``testing.median_ms``): with ``busy`` the device's time alone,
    without it the call's."""
    from genrich_tpu_torch import testing
    return testing.median_ms(fn, n, busy, BUSY_CYCLES)


def _close(a, b, rtol=TOL, atol=TOL):
    import torch
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def _bound(nbytes, fp32_ops=0, fp64_ops=0):
    """The bound of work that moves ``nbytes`` and runs these operations
    (``testing.bound``), with its terms."""
    from genrich_tpu_torch import testing
    ms, by = testing.bound(nbytes, fp32_ops, fp64_ops)
    return {"bound_ms": ms, "bound_by": by, "bytes": int(nbytes),
            "fp32_ops": int(fp32_ops), "fp64_ops": int(fp64_ops)}


def _bound_ms(nbytes):
    """The least time to move ``nbytes`` through device memory."""
    return _bound(nbytes)["bound_ms"]


def _sum_bounds(parts):
    """One bound over several calls: their bytes and operations add."""
    return _bound(sum(p["bytes"] for p in parts),
                  sum(p["fp32_ops"] for p in parts),
                  sum(p["fp64_ops"] for p in parts))


def _stats_bound(args):
    """K2's bound on these arguments, its operations counted."""
    from genrich_tpu_torch import testing
    c = testing.tile_stats_opcount(*args)
    return dict(_bound(testing.stats_bytes(c["rows"]), c["fp32_ops"]),
                branches=c["branches"])


def _fisher_bound(pv):
    """K3's bound on these rows, its operations counted."""
    from genrich_tpu_torch import testing
    c = testing.fisher_combine_opcount(pv)
    r, n = pv.shape
    return dict(_bound(_fisher_bytes(r, n), c["fp32_ops"], c["fp64_ops"]),
                paths=c["paths"], trips=c["trips"])


def _fisher_bytes(r, n):
    """K3: r x f32 -log10 p in, f32 out."""
    return 4 * n * (r + 1)


def scan_stats_phase():
    """K1 and K2 against their plain versions (K1 also against its first
    design); returns JSON entries, K1's to be completed on the main
    path's inputs."""
    import torch
    from genrich_tpu_torch import testing
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
        carry = torch.tensor(CARRY8, dtype=torch.int32, device=dev)
        # K1, main-path mode: two groups, coverage only
        vals, _ = scan.coverage_scan(packed, 2, carry)
        ref, _ = scan.coverage_scan_plain(packed, 2, carry)
        first, _ = testing.coverage_scan_first_design(packed, 2, carry)
        torch.cuda.synchronize()
        g2_err = float((vals - ref).abs().max())
        if not torch.equal(vals, ref):
            raise AssertionError(f"coverage_scan G=2 M={m}: not bitwise "
                                 f"(max abs err {g2_err})")
        if not torch.equal(vals, first):
            raise AssertionError(f"coverage_scan G=2 M={m}: differs from "
                                 f"the first design")
        # K1, lambda mode: one group + -log10 p against lambda
        p1 = packed & 0x3FF
        c4 = carry[:4].contiguous()
        v1, pv1 = scan.coverage_scan(p1, 1, c4, lam=2.5)
        rv1, rpv1 = scan.coverage_scan_plain(p1, 1, c4, lam=2.5)
        fv1, fpv1 = testing.coverage_scan_first_design(p1, 1, c4, lam=2.5)
        torch.cuda.synchronize()
        if not torch.equal(v1, rv1):
            raise AssertionError(f"coverage_scan G=1 M={m}: vals differ")
        if not (torch.equal(v1, fv1) and torch.equal(pv1, fpv1)):
            raise AssertionError(f"coverage_scan G=1 M={m}: differs from "
                                 f"the first design")
        p_err = float((pv1 - rpv1).abs().max())
        if not _close(pv1, rpv1):
            raise AssertionError(f"coverage_scan G=1 M={m}: p max abs "
                                 f"err {p_err}")
        # K2 on the G=2 coverage, with a 5% excluded mask
        ex = torch.from_numpy(rng.rand(m) < 0.05).to(dev)
        ev, cr = vals[0].clamp_min(0), vals[1].clamp_min(0)
        pv = pipeline.tile_stats(ev, cr, ex, 1.37, 2.5)
        rpv = pipeline.tile_stats_plain(ev, cr, ex, 1.37, 2.5)
        fpv = testing.tile_stats_first_design(ev, cr, ex, 1.37, 2.5)
        torch.cuda.synchronize()
        st_err = float((pv - rpv).abs().max())
        if not _close(pv, rpv):
            raise AssertionError(f"tile_stats M={m}: max abs err "
                                 f"{st_err}")
        if not torch.equal(pv, fpv):
            raise AssertionError(f"tile_stats M={m}: differs from the "
                                 f"first design")
        res = {"g2_max_abs_err": g2_err, "g1_p_max_abs_err": p_err,
               "stats_max_abs_err": st_err}
        if m == M_MAIN:
            lam_ops = testing.coverage_scan_opcount(m, 1, v1[0], 2.5)
            bounds = {
                "g2": _bound(testing.scan_bytes(m, 2, None),
                             testing.coverage_scan_opcount(m, 2)["fp32_ops"]),
                "g1": dict(_bound(testing.scan_bytes(m, 1, 2.5),
                                  lam_ops["fp32_ops"]),
                           branches=lam_ops["branches"]),
                "stats": _stats_bound((ev, cr, ex, 1.37, 2.5))}
            say("bounds", m=m, **bounds)
            res.update(
                g2_ms=_median_ms(lambda: scan.coverage_scan(packed, 2,
                                                            carry)),
                g2_first_design_ms=_median_ms(
                    lambda: testing.coverage_scan_first_design(
                        packed, 2, carry)),
                g2_plain_ms=_median_ms(
                    lambda: scan.coverage_scan_plain(packed, 2, carry)),
                g1_ms=_median_ms(lambda: scan.coverage_scan(
                    p1, 1, c4, lam=2.5)),
                g1_first_design_ms=_median_ms(
                    lambda: testing.coverage_scan_first_design(
                        p1, 1, c4, lam=2.5)),
                g1_plain_ms=_median_ms(lambda: scan.coverage_scan_plain(
                    p1, 1, c4, lam=2.5)),
                stats_ms=_median_ms(lambda: pipeline.tile_stats(
                    ev, cr, ex, 1.37, 2.5)),
                stats_first_design_ms=_median_ms(
                    lambda: testing.tile_stats_first_design(
                        ev, cr, ex, 1.37, 2.5)),
                stats_plain_ms=_median_ms(lambda: pipeline.tile_stats_plain(
                    ev, cr, ex, 1.37, 2.5)))
        out[m] = res
        say("kernels", m=m, **res)
        del packed, vals, ref, first, p1, v1, pv1, rv1, rpv1, fv1, fpv1
        del ex, ev, cr, pv, rpv, fpv
        torch.cuda.empty_cache()
    main, ragged = out[M_MAIN], out[M_RAGGED]

    def worst(key):
        return max(main[key], ragged[key])
    return [
        {"name": "coverage_scan", "route": "cuda",
         "source": "genrich_tpu_torch/csrc/scan.cu",
         "replaces": "genrich_tpu/ops/pallas_scan.py:44",
         "launches": 0, "max_abs_err": worst("g2_max_abs_err"),
         "library_ms": None,
         "at_2^23": {
             "mode": "G=2 coverage (main-path mode), M=2^23",
             "ms": main["g2_ms"],
             "first_design_ms": main["g2_first_design_ms"],
             "plain_ms": main["g2_plain_ms"], **bounds["g2"]},
         "lambda_mode": {"p_max_abs_err": worst("g1_p_max_abs_err"),
                         "ms": main["g1_ms"],
                         "first_design_ms": main["g1_first_design_ms"],
                         "plain_ms": main["g1_plain_ms"],
                         **{k: v for k, v in bounds["g1"].items()
                            if k != "branches"}}},
        {"name": "tile_stats", "route": "cuda",
         "source": "genrich_tpu_torch/csrc/stats.cu",
         "replaces": "genrich_tpu/ops/pipeline_jax.py:164",
         "launches": 0, "max_abs_err": worst("stats_max_abs_err"),
         "library_ms": None,
         "at_2^23": {"ms": main["stats_ms"],
                     "first_design_ms": main["stats_first_design_ms"],
                     "plain_ms": main["stats_plain_ms"],
                     **{k: v for k, v in bounds["stats"].items()
                        if k != "branches"}}},
    ]


def _cu(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA driver error {rc}")


_CAPTURE = {}     # the side stream every capture runs on


def _kernel_launches(fn):
    """Names of the kernels that one call of ``fn`` launches, and the
    number of its memset nodes: ``fn`` runs once on a side stream (as
    CUDA graph capture asks), then the call is captured on that stream
    into a CUDA graph, not run, and the graph's nodes are read with the
    driver API.  torch.profiler cannot be trusted with this count on the
    H100 host: after the smoke's end-to-end runs it often recorded a
    call's launch but not the kernel's device record (PERF.md, section
    7)."""
    import ctypes
    import torch
    cu = ctypes.CDLL("libcuda.so.1")
    side = _CAPTURE.setdefault("stream", torch.cuda.Stream())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names, memsets = [], 0
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
            "cuGraphNodeGetType")
        memsets += kind.value == 2           # CU_GRAPH_NODE_TYPE_MEMSET
        if kind.value != 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at word 0, kern at word 7
        params = (ctypes.c_void_p * 16)()
        _cu(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
            "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if params[0]:
            _cu(cu.cuFuncGetName(ctypes.byref(name),
                                 ctypes.c_void_p(params[0])), "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params[7])),
                "cuKernelGetName")
        names.append(name.value.decode())
    graph.reset()
    return names, memsets


def _kernels_per_call(name, fn, where, memsets=None):
    """The kernels one call of ``fn`` (a wrapper of kernel ``name``)
    launches, by graph capture; they must be
    ``kernels.KERNELS_PER_CALL[name]``, the table prof.py holds the
    profiler's records to, and where ``memsets`` is given, the call's
    memset nodes that many."""
    from genrich_tpu_torch import kernels
    ran, ran_memsets = _kernel_launches(fn)
    want = kernels.KERNELS_PER_CALL[name]
    if len(ran) != len(want) or not all(
            kernels.is_kernel(r, w) for r, w in zip(ran, want)):
        raise AssertionError(f"{name}, {where}: launched {ran}, not "
                             f"{list(want)}")
    if memsets is not None and ran_memsets != memsets:
        raise AssertionError(f"{name}, {where}: {ran_memsets} memsets per "
                             f"call, not {memsets}")
    return ran


def _k1_bitwise(packed, groups, carry, lam):
    """K1 against its plain version and its first design, bitwise on
    the coverage; returns K1's output."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import scan
    got = scan.coverage_scan(packed, groups, carry, lam)
    want = scan.coverage_scan_plain(packed, groups, carry, lam)
    first = testing.coverage_scan_first_design(packed, groups, carry, lam)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[0], first[0])):
        return None
    return got


def k1_path_phase(calls, path):
    """K1 on the inputs of a path's own calls (host copies of
    coverage_scan's arguments): bitwise to its plain version and its
    first design, and one kernel per call (``_kernel_launches``);
    returns the sums over the calls.  A call
    whose carry is zero is held once more with CARRY8 (its first
    4 * groups entries) as its carry, so the carried scan is held on
    the path's own rows."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import scan
    dev = torch.device(DEV)
    ms = call_ms = first_ms = plain_ms = 0.0
    nonzero = 0
    parts = []
    for i, call in enumerate(calls):
        packed, groups, carry, lam = (list(call) + [None, None])[:4]
        packed, carry = packed.to(dev), carry.to(dev)
        got = _k1_bitwise(packed, groups, carry, lam)
        alt = carry if bool((carry != 0).any()) else torch.tensor(
            CARRY8[:4 * groups], dtype=torch.int32, device=dev)
        if got is None or _k1_bitwise(packed, groups, alt, lam) is None:
            raise AssertionError(f"coverage_scan, {path} path call {i}: "
                                 f"not bitwise")
        ran = _kernels_per_call("coverage_scan", lambda: scan.coverage_scan(
            packed, groups, carry, lam), f"{path} path call {i}")
        nonzero += bool((carry != 0).any())
        m = packed.shape[0]
        parts.append(_bound(testing.scan_bytes(m, groups, lam),
                            testing.coverage_scan_opcount(
                                m, groups, got[0][0], lam)["fp32_ops"]))
        res = {"rows": m, "groups": groups, "kernels_per_call": ran,
               "ms": _median_ms(lambda: scan.coverage_scan(
                   packed, groups, carry, lam)),
               "call_ms": _median_ms(lambda: scan.coverage_scan(
                   packed, groups, carry, lam), busy=False),
               "first_design_ms": _median_ms(
                   lambda: testing.coverage_scan_first_design(
                       packed, groups, carry, lam)),
               "plain_ms": _median_ms(lambda: scan.coverage_scan_plain(
                   packed, groups, carry, lam)), **parts[-1]}
        ms += res["ms"]
        call_ms += res["call_ms"]
        first_ms += res["first_design_ms"]
        plain_ms += res["plain_ms"]
        say("kernels", kernel="coverage_scan",
            inputs=f"{path} path call {i}",
            carry=[int(x) for x in carry.tolist()], **res)
        del packed, carry, got
    torch.cuda.empty_cache()
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                first_design_ms=first_ms, **_sum_bounds(parts),
                max_abs_err=0.0, calls_with_nonzero_carry=nonzero,
                mode=f"sum over the {path} path's {len(calls)} calls, its "
                     f"own inputs; one kernel launch per call")


def fisher_phase():
    """K3 against its float64 plain version and its first design
    (bitwise); returns a JSON entry."""
    import torch
    from genrich_tpu_torch import testing
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
            first = testing.fisher_combine_first_design(pv)
            torch.cuda.synchronize()
            if not torch.equal(got == -1.0, want == -1.0):
                raise AssertionError(f"fisher_combine R={r} N={n}: SKIP "
                                     f"lanes differ")
            if not torch.equal(got, first):
                raise AssertionError(f"fisher_combine R={r} N={n}: differs "
                                     f"from the first design")
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
                                pv), n=5), _fisher_bound(pv),
                            _median_ms(
                                lambda: testing.fisher_combine_first_design(
                                    pv)))
                res.update(ms=times[r][0], plain_ms=times[r][1],
                           first_design_ms=times[r][3], **times[r][2])
            say("kernels", kernel="fisher_combine", **res)
            del pv, got, want, first, err
    torch.cuda.empty_cache()
    return {"name": "fisher_combine", "route": "cuda",
            "source": "genrich_tpu_torch/csrc/fisher.cu",
            "replaces": "genrich_tpu/ops/chisq_jax.py:174",
            "launches": 0, "max_abs_err": worst_err,
            "library_ms": None,
            "at_2^23": {"ms": times[2][0], "plain_ms": times[2][1],
                        "first_design_ms": times[2][3],
                        **{k: v for k, v in times[2][2].items()
                           if k not in ("paths", "trips")},
                        "r3_ms": times[3][0], "r3_plain_ms": times[3][1],
                        "r3_first_design_ms": times[3][3],
                        "r3_bound_ms": times[3][2]["bound_ms"],
                        "r3_bound_by": times[3][2]["bound_by"]},
            "max_rel_err": worst_rel}


def _k4_first_design(args):
    from genrich_tpu_torch import testing
    starts, ends, stat, pval, qval, sig, first, last, min_pq = args
    return testing.peak_reduce_first_design(starts, ends, stat, pval, qval,
                                            sig, first, last, min_pq)


def _k4_bytes(args):
    """K4's bytes on these inputs (``testing.peak_reduce_bytes``)."""
    from genrich_tpu_torch import testing
    return testing.peak_reduce_bytes(args[6], args[7])


def _hold_k4(args, min_pq):
    """K4 against its plain version (summit fields exact, AUC rtol
    1e-5), against the exact engine's float32 row-order sum on the host
    (AUC bitwise), against its first design (all six outputs bitwise,
    every candidate), and twice in a row (bitwise); ``args`` are
    peak_reduce's arguments on the card.  Returns error figures."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    starts, ends, stat, _, _, sig, first, last, _ = args
    got = peaks.peak_reduce(*args)
    want = peaks.peak_reduce_plain(*args)
    again = peaks.peak_reduce(*args)
    old = _k4_first_design(args)
    torch.cuda.synchronize()
    ex = last >= first
    names = ("auc", "max_stat", "summit_pval", "summit_qval",
             "summit_pos", "summit_len")
    for name, g, w in list(zip(names, got, want))[1:]:
        if not torch.equal(g[ex], w[ex]):
            raise AssertionError(f"peak_reduce: {name} differs")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("peak_reduce: two runs differ")
    for name, g, o in zip(names, got, old):
        if not torch.equal(g, o):
            raise AssertionError(f"peak_reduce: {name} differs from the "
                                 f"first design")
    auc, plain_auc = got[0][ex], want[0][ex]
    a_err = (auc - plain_auc).abs()
    rel = float((a_err / plain_auc.abs().clamp_min(1e-30)).max()) \
        if a_err.numel() else 0.0
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
    some = rows.numel() > 0          # a tile past the chromosome has none
    return {"peaks": int(ex.sum()), "candidates": int(first.shape[0]),
            "first_design_bitwise": True,
            "rows_per_peak_median": float(rows.double().median())
            if some else 0.0,
            "rows_per_peak_max": int(rows.max()) if some else 0,
            "auc_max_abs_err": float(a_err.max()) if some else 0.0,
            "auc_max_rel_err": rel,
            "plain_auc_differs_bitwise": int((plain_auc.cpu().numpy()
                                              != ref).sum())}


def k4_path_phase(calls, path):
    """K4 on the inputs of a path's own calls (host copies of
    peak_reduce's arguments), held by ``_hold_k4``; returns the sums
    over the calls."""
    import torch
    from genrich_tpu_torch.ops import peaks
    dev = torch.device(DEV)
    ms = call_ms = plain_ms = first_ms = first_call_ms = 0.0
    nbytes = chain_ms = 0.0
    worst_err = worst_rel = 0.0
    for i, call in enumerate(calls):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in call]
        res = _hold_k4(args, call[-1])
        res.update(kernels_per_call=_kernels_per_call(
            "peak_reduce", lambda: peaks.peak_reduce(*args),
            f"{path} path call {i}"), rows=int(args[0].shape[0]),
                   ms=_median_ms(lambda: peaks.peak_reduce(*args)),
                   call_ms=_median_ms(lambda: peaks.peak_reduce(*args),
                                      busy=False),
                   first_design_ms=_median_ms(
                       lambda: _k4_first_design(args)),
                   first_design_call_ms=_median_ms(
                       lambda: _k4_first_design(args), busy=False),
                   plain_ms=_median_ms(
                       lambda: peaks.peak_reduce_plain(*args)),
                   bound_ms=_bound_ms(_k4_bytes(args)),
                   add_chain_floor_ms=res["rows_per_peak_max"]
                   * FADD_CYCLES / SM_CLOCK_HZ * 1e3)
        ms += res["ms"]
        call_ms += res["call_ms"]
        plain_ms += res["plain_ms"]
        first_ms += res["first_design_ms"]
        first_call_ms += res["first_design_call_ms"]
        nbytes += _k4_bytes(args)
        chain_ms += res["add_chain_floor_ms"]
        worst_err = max(worst_err, res["auc_max_abs_err"])
        worst_rel = max(worst_rel, res["auc_max_rel_err"])
        say("kernels", kernel="peak_reduce", inputs=f"{path} path call {i}",
            **res)
        del args
    torch.cuda.empty_cache()
    return {"max_abs_err": worst_err, "auc_max_rel_err": worst_rel,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "first_design_ms": first_ms,
            "first_design_call_ms": first_call_ms,
            "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
            "add_chain_floor_ms": chain_ms,
            "mode": f"sum over the {path} path's {len(calls)} calls, its "
                    f"own inputs; AUC bitwise to the row-order sum, all "
                    f"outputs bitwise to the first design"}


def peaks_phase(main_calls):
    """K4 on the inputs of the main path's own calls (``main_calls``,
    host copies) and on 2^23 synthetic rows holding about 30,000 short
    peaks; returns a JSON entry whose times are the main path's."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    dev = torch.device(DEV)
    main = k4_path_phase(main_calls, "main")
    min_pq = 2.0
    rows = [torch.from_numpy(a).to(dev) for a in testing.peak_row_columns(
        np.random.RandomState(2), M_MAIN, PEAKS_K4, region_rows=(3, 200),
        min_pq=min_pq)]
    live = torch.ones(M_MAIN, dtype=torch.bool, device=dev)
    c = peaks.peak_candidates(*rows[:3], live, min_pq, 100, 1 << 16)
    args = rows + [c.sig, c.first, c.last, min_pq]
    syn = _hold_k4(args, min_pq)
    syn.update(rows=M_MAIN,
               ms=_median_ms(lambda: peaks.peak_reduce(*args)),
               call_ms=_median_ms(lambda: peaks.peak_reduce(*args),
                                  busy=False),
               first_design_ms=_median_ms(lambda: _k4_first_design(args)),
               first_design_call_ms=_median_ms(
                   lambda: _k4_first_design(args), busy=False),
               plain_ms=_median_ms(lambda: peaks.peak_reduce_plain(*args)),
               bound_ms=_bound_ms(_k4_bytes(args)))
    say("kernels", kernel="peak_reduce", inputs="synthetic", **syn)
    del rows, args, c, live
    torch.cuda.empty_cache()
    return {"name": "peak_reduce", "route": "cuda",
            "source": "genrich_tpu_torch/csrc/peaks.cu",
            "replaces": "genrich_tpu/ops/peaks_jax.py:85",
            "launches": 0, "library_ms": None, **main,
            "max_abs_err": max(main["max_abs_err"], syn["auc_max_abs_err"]),
            "auc_max_rel_err": max(main["auc_max_rel_err"],
                                   syn["auc_max_rel_err"]),
            "synthetic": {k: syn[k] for k in (
                "rows", "peaks", "ms", "call_ms", "first_design_ms",
                "first_design_call_ms", "plain_ms", "bound_ms")}}


def _k5_first_design(args):
    from genrich_tpu_torch import testing
    return testing.gap_join_first_design(*args)


def _hold_k5(args, where):
    """K5 (``peak_candidates`` on the card) against its plain version and
    its first design on the same inputs, every output bitwise, and twice
    in a row (bitwise); returns its output."""
    import torch
    from genrich_tpu_torch.ops import peaks
    got = peaks.peak_candidates(*args)
    again = peaks.peak_candidates(*args)
    want = peaks.peak_candidates_plain(*args)
    old = _k5_first_design(args)
    torch.cuda.synchronize()
    for name, g, a, w, o in zip(got._fields, got, again, want, old):
        if not torch.equal(g, w):
            raise AssertionError(f"gap_join, {where}: {name} differs from "
                                 f"the plain version")
        if not torch.equal(g, a):
            raise AssertionError(f"gap_join, {where}: {name} differs "
                                 f"between two runs")
        if not torch.equal(g, o):
            raise AssertionError(f"gap_join, {where}: {name} differs from "
                                 f"the first design")
    return got


def _k5_times(args, got, where):
    """K5's times, its first design's and its plain version's, its bound
    and its device kernels per call (graph capture: one kernel, no
    memset) on these inputs."""
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    m, k, n = args[0].shape[0], got.first.shape[0], int(got.n)
    res = {"rows": m, "slots": k, "peaks": n,
           "sig_rows": int(got.sig.sum()), "skp_rows": int(got.skp.sum()),
           "ms": _median_ms(lambda: peaks.peak_candidates(*args)),
           "call_ms": _median_ms(lambda: peaks.peak_candidates(*args),
                                 busy=False),
           "first_design_ms": _median_ms(lambda: _k5_first_design(args)),
           "first_design_call_ms": _median_ms(
               lambda: _k5_first_design(args), busy=False),
           "plain_ms": _median_ms(
               lambda: peaks.peak_candidates_plain(*args)),
           **_bound(testing.gap_join_bytes(m, k)),
           "kernels_per_call": _kernels_per_call(
               "gap_join", lambda: peaks.peak_candidates(*args), where,
               memsets=0),
           "memsets_per_call": 0}
    return res


def k5_path_phase(calls, path):
    """K5 on the inputs of a path's own calls (host copies of
    peak_candidates' arguments), bitwise to its plain version and its
    first design, with the device kernels of each call read by graph
    capture; returns the sums over the calls."""
    import torch
    dev = torch.device(DEV)
    parts = []
    for i, call in enumerate(calls):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in call]
        where = f"{path} path call {i}"
        res = _k5_times(args, _hold_k5(args, where), where)
        parts.append(res)
        say("kernels", kernel="gap_join", inputs=where, **res)
        del args
    torch.cuda.empty_cache()
    return dict({key: sum(p[key] for p in parts)
                 for key in ("ms", "call_ms", "first_design_ms",
                             "first_design_call_ms", "plain_ms", "rows",
                             "peaks")},
                **_sum_bounds(parts), max_abs_err=0.0,
                mode=f"sum over the {path} path's {len(calls)} calls, its "
                     f"own inputs; every output bitwise to the plain "
                     f"version and the first design")


def gap_join_phase(main_calls):
    """K5 on the inputs of the main path's own calls and on 2^23
    synthetic rows (``testing.gap_join_rows``: SKIP, dead and
    zero-length rows, gaps of exactly max_gap, a dead tail) holding far
    more peaks than the engines' 4,096 slots; returns a JSON entry whose
    times are the main path's."""
    import torch
    from genrich_tpu_torch import testing
    main = k5_path_phase(main_calls, "main")
    rows = testing.gap_join_rows(np.random.RandomState(3), M_MAIN, 100,
                                 400_000, dead_tail=5_000)
    args = [torch.from_numpy(a).to(torch.device(DEV)) for a in rows] \
        + [2.0, 100, 4096]
    got = _hold_k5(args, "synthetic")
    if int(got.n) <= 4096 or int(got.exists.sum()) != 4096:
        raise AssertionError(f"gap_join synthetic: {int(got.n)} peaks, "
                             f"not more than the 4,096 slots")
    syn = _k5_times(args, got, "synthetic")
    say("kernels", kernel="gap_join", inputs="synthetic", **syn)
    del args, got
    torch.cuda.empty_cache()
    return {"name": "gap_join", "route": "cuda",
            "source": "genrich_tpu_torch/csrc/gapjoin.cu",
            "replaces": "genrich_tpu/ops/peaks_jax.py:54",
            "launches": 0, "library_ms": None, **main,
            "synthetic": {k: syn[k] for k in (
                "rows", "peaks", "ms", "call_ms", "first_design_ms",
                "first_design_call_ms", "plain_ms", "bound_ms", "bound_by",
                "bytes")}}


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


def _summits(ref_path, ref_log, out_path):
    """Column 10, the summit offset, of the matched rows (columns 1-3)
    against the exact engine's: each equal, or a near tie that the exact
    engine's -f log ``ref_log`` shows (``testing.check_summits``: the
    two summits' intervals have stats within SUMMIT_TOL relative); any
    other difference raises.  Returns the rows compared and the rows
    that differ (each a near tie)."""
    from genrich_tpu_torch import testing
    with open(ref_path) as f, open(out_path) as g:
        n, ties = testing.check_summits(f.read().splitlines(),
                                        g.read().splitlines(), ref_log,
                                        SUMMIT_TOL)
    return {"compared": n, "differ_near_ties": ties}


def _merge_counts(perf):
    """The device's interval rows before and after the merge into the
    exact engine's intervals (``stats_all``; summed over replicates)."""
    return {k: perf[k] for k in ("interval_rows", "real_rows",
                                 "merged_rows", "merged_width")}


def _native_used() -> bool:
    """The port's ingest library is loaded in this process, from its
    _build/, and no file under the repo's native/ is mapped."""
    from genrich_tpu_torch import kernels, testing
    from genrich_tpu_torch.ingest import native
    return native._lib is not None \
        and os.path.dirname(native.INFO["path"]) == str(kernels.BUILD_DIR) \
        and not testing.mapped_files(os.path.join(REPO, "native"))


def run_port_exact(label: str, args):
    """The port's ``--engine exact -v`` on ``args`` in this process (host
    code only); returns its wall and its stderr."""
    from genrich_tpu_torch import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args + ["-v", "--engine", "exact"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"port exact engine ({label}) exit code {rc}: "
                             f"{err.getvalue()[-2000:]}")
    if not _native_used():
        raise AssertionError(f"port exact engine ({label}) used Python "
                             f"ingest")
    return wall, err.getvalue()


def _md5(path) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def exact_oracle(label: str, args, outputs):
    """The port's ``--engine exact -v`` (this process, host code only)
    on ``args``, writing ``outputs`` ({output flag: path}): the oracle
    of the device paths (tests/test_torch_exact.py holds its bytes to
    the JAX package's on every flag set).  Prints its wall (host
    seconds of its ``cli.main`` call on the card's machine), its peak
    count and each output's md5."""
    with probe(EXACT_LAMBDA.setdefault(label, {})):
        port_wall, err = run_port_exact(label, args + [
            x for flag, path in outputs.items() for x in (flag, path)])
    say(f"{label}_exact", port_wall_s=port_wall,
        walls="host s of the port's cli.main", ingest="native",
        peaks=sum(1 for _ in open(outputs["-o"])),
        md5={flag: _md5(path) for flag, path in outputs.items()},
        stderr_lines=err.count("\n"))
    return port_wall


@contextmanager
def probe(seen):
    """While the block runs, ``seen`` gets the fragment sums, lambda and
    control factor each engine takes (the device engines'
    ``coverage_finish`` and ``stats_all``, the port's exact engine's
    ``_calc_lambda`` and ``calc_factor``)."""
    from genrich_tpu_torch import pipeline
    from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
    from genrich_tpu_torch.engine.torch_bridge import TorchEngine
    real = []

    def patch(obj, name, keep):
        fn = getattr(obj, name)
        real.append((obj, name, fn))

        def wrapped(*args):
            out = fn(*args)
            keep(args, out)
            return out
        setattr(obj, name, wrapped)

    def add(key, value):
        seen.setdefault(key, []).append(value)
    for cls in (TorchEngine, ShardedTorchEngine):
        patch(cls, "coverage_finish",
              lambda a, out: add("frag", [float(x) for x in out]))
        patch(cls, "stats_all", lambda a, out: add("lam_factor", [
            float(np.float32(a[1])), float(np.float32(a[2]))]))
    patch(pipeline, "_calc_lambda", lambda a, out: (
        add("frag", [float(a[1])]), add("lam_factor", [float(out)])))
    patch(pipeline, "calc_factor", lambda a, out: (
        add("ctrl_frag", float(a[1])), add("factor", float(out))))
    try:
        yield seen
    finally:
        for obj, name, fn in reversed(real):
            setattr(obj, name, fn)


def run_port(label: str, args, seen=None):
    """One port run on the card; returns (wall, launches, perf, memory).
    ``seen`` gets what ``probe`` records."""
    from genrich_tpu_torch import cli, kernels
    from genrich_tpu_torch.engine import perf as eperf
    perf = {}
    eperf.synchronize_cards()
    eperf.reset_peak_memory()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with probe({} if seen is None else seen):
        rc = cli.main(args + ["--device", DEV], perf=perf)
    eperf.synchronize_cards()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"port run ({label}) exit code {rc}")
    if not _native_used():
        raise AssertionError(f"port run ({label}) used Python ingest")
    return wall, counts, perf, max(eperf.peak_memory())


EXACT_LAMBDA = {}    # path -> the port's exact engine's probe record


def _lambda_line(name, ref, seen):
    """The device engine's fragment sums, lambda and factor beside the
    port's exact engine's on the same input; they must be equal: every
    term of the ATAC BAMs is an integer, so both float64 sums are exact
    (``ops/pipeline.frag_sum``)."""
    exact = EXACT_LAMBDA[ref]
    # the exact engine records lambda per replicate and the factor apart
    want_lf = [[lf[0], f] for lf, f in zip(
        exact["lam_factor"], exact.get("factor", [1.0] * 8))]
    same = seen["lam_factor"] == want_lf
    say(f"{name}_lambda", device=seen["lam_factor"], exact=want_lf,
        device_frag=seen["frag"], exact_frag=exact["frag"],
        exact_ctrl_frag=exact.get("ctrl_frag"), equal=same)
    if not same:
        raise AssertionError(f"{name}: lambda or factor differs from the "
                             f"exact engine's")


def peak_runs(name: str, ts, need, extra=(), ref=None, flags=FLAGS,
              thresh=Q_THRESH):
    """The port's exact engine once (unless ``ref`` names the exact
    engine's file of an earlier phase on the same input), then the port
    cold and warm on ``-t ts``, the
    flags ``extra`` and ``flags`` (whose significance threshold is
    ``thresh``); checks the rows, the launch counts (``need(counts)``
    returns a fault or None), that no chromosome went to the host peak
    caller (every chromosome of the smoke is under 2^31 bp) and that
    cold and warm wrote the same bytes.  Returns the counts and perf of
    the warm run."""
    from genrich_tpu_torch.bench import _verify_rows
    run_dir = os.path.join(WORK, "chip_smoke")
    os.makedirs(run_dir, exist_ok=True)
    ref_np = os.path.join(run_dir, f"{ref or name}_exact.np")
    ref_log = os.path.join(run_dir, f"{ref or name}_exact.log")
    if ref is None:
        exact_oracle(name, ["-t", ts, *extra] + flags,
                   {"-o": ref_np, "-f": ref_log})
    counts = {}
    for label in ("cold", "warm"):
        out_np = os.path.join(run_dir, f"{name}_port_{label}.np")
        seen = {}
        wall, counts, perf, mem = run_port(
            f"{name} {label}", ["-t", ts, "-o", out_np, *extra] + flags,
            seen)
        _lambda_line(f"{name}_{label}", ref or name, seen)
        rows = _verify_rows(ref_np, out_np, thresh=thresh)
        diffs = _rel_diffs(ref_np, out_np)
        say(f"{name}_port_{label}", wall_s=wall, launches=counts,
            ingest="native", max_memory_allocated=mem, rows=rows,
            worst_rel_diff=diffs, merge=_merge_counts(perf),
            summits=_summits(ref_np, ref_log, out_np), perf=perf)
        fault = need(counts)
        if fault:
            raise AssertionError(f"{name} ({label}): {fault}: {counts}")
        if perf["host_peak_chroms"]:
            raise AssertionError(f"{name} ({label}): the host peak caller "
                                 f"finished {perf['host_peak_chroms']} "
                                 f"chromosomes")
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
    return counts, perf


def _need_main(c):
    missing = [k for k in ("coverage_scan", "tile_stats", "gap_join",
                           "peak_reduce") if c[k] <= 0]
    return f"kernels not launched: {missing}" if missing else None


def _need_every(c):
    missing = [k for k, n in c.items() if n <= 0]
    return f"kernels not launched: {missing}" if missing else None


def main_path(bam):
    return peak_runs("main", bam, _need_main)[0]


def control_path(bam_t, bam_c):
    """``-t bam_t -c bam_c``: the one run where K2 meets a control that
    varies from row to row."""
    return peak_runs("control", bam_t, _need_main, ["-c", bam_c])[0]


def kernel_inputs(label, ts, targets, extra=(), flags=FLAGS):
    """One more port run on ``-t ts``, ``extra`` and ``flags`` (untimed,
    its counts unread) ``recording`` the calls of ``targets``; returns
    {name: [args, ...]}."""
    from genrich_tpu_torch.testing import recording
    os.makedirs(os.path.join(WORK, "chip_smoke"), exist_ok=True)
    with recording(targets) as calls:
        run_port(f"{label}, kernel inputs", ["-t", ts, "-o", os.path.join(
            WORK, "chip_smoke", f"{label}_kernel_inputs.np"), *extra]
            + flags)
    empty = [name for name, c in calls.items() if not c]
    if empty:
        raise AssertionError(f"{label}: no call of {empty}")
    return calls


def main_kernel_inputs(bam):
    """The arguments of the main path's K1, K2 and K4 calls and of its
    row merge."""
    from genrich_tpu_torch.engine import torch_bridge
    from genrich_tpu_torch.ops import compact, peaks, pipeline
    return kernel_inputs("main", bam, [(pipeline, "coverage_scan"),
                                       (compact, "pileup_runs"),
                                       (torch_bridge, "tile_stats"),
                                       (peaks, "peak_candidates"),
                                       (peaks, "peak_reduce")])


def control_kernel_inputs(bam_t, bam_c):
    """The arguments of the control run's row merge, K2 and K4 calls."""
    from genrich_tpu_torch.engine import torch_bridge
    from genrich_tpu_torch.ops import compact, peaks
    return kernel_inputs("control", bam_t, [(compact, "pileup_runs"),
                                            (torch_bridge, "tile_stats"),
                                            (peaks, "peak_candidates"),
                                            (peaks, "peak_reduce")],
                         ["-c", bam_c])


def merge_phase(calls, path):
    """The row merge (``compact.pileup_runs``, plain PyTorch) on the
    inputs of a path's own calls: on the card against the same code on
    the CPU (every output bitwise), its device and call times (summed
    over the calls) and the rows it took and gave."""
    import torch
    from genrich_tpu_torch.ops import compact
    dev = torch.device(DEV)
    out = {"calls": len(calls), "rows": 0, "real_rows": 0, "intervals": 0,
           "ms": 0.0, "call_ms": 0.0}
    for i, call in enumerate(calls):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in call]
        got = compact.pileup_runs(*args)
        want = compact.pileup_runs(*call)
        for name, g, w in zip(got._fields, got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"pileup_runs, {path} path call {i}: "
                                     f"{name} differs from the CPU's")
        out["rows"] += int(args[0].shape[0])
        out["real_rows"] += int(got.n_rows)
        out["intervals"] += int(got.n)
        out["ms"] += _median_ms(lambda: compact.pileup_runs(*args))
        out["call_ms"] += _median_ms(lambda: compact.pileup_runs(*args),
                                     busy=False)
        del args, got
    torch.cuda.empty_cache()
    say("merge", path=path, **out)
    return out


def fisher_kernel_inputs(bam_a, bam_b):
    """The arguments of the Fisher path's K3 and K5 calls."""
    from genrich_tpu_torch.ops import compact, peaks
    return kernel_inputs("fisher", f"{bam_a},{bam_b}",
                         [(compact, "fisher_combine"),
                          (peaks, "peak_candidates")])


def k2_path_phase(calls, path):
    """K2 on the inputs of a path's own calls, against its plain version
    (rtol = atol = 1e-5) and its first design (bitwise); returns the sums
    over the calls."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import pipeline
    dev = torch.device(DEV)
    ms = call_ms = plain_ms = first_ms = worst = 0.0
    excluded = 0
    parts = []
    for i, call in enumerate(calls):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in call]
        excluded += int(call[2].sum())
        got = pipeline.tile_stats(*args)
        want = pipeline.tile_stats_plain(*args)
        first = testing.tile_stats_first_design(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not _close(got, want):
            raise AssertionError(f"tile_stats, {path} path call {i}: max "
                                 f"abs err {err}")
        if not torch.equal(got, first):
            raise AssertionError(f"tile_stats, {path} path call {i}: "
                                 f"differs from the first design")
        m = args[0].shape[0]
        res = {"rows": m, "excluded_rows": int(call[2].sum()),
               "max_abs_err": err,
               "kernels_per_call": _kernels_per_call(
                   "tile_stats", lambda: pipeline.tile_stats(*args),
                   f"{path} path call {i}"),
               "ms": _median_ms(lambda: pipeline.tile_stats(*args)),
               "call_ms": _median_ms(lambda: pipeline.tile_stats(*args),
                                     busy=False),
               "first_design_ms": _median_ms(
                   lambda: testing.tile_stats_first_design(*args)),
               "plain_ms": _median_ms(
                   lambda: pipeline.tile_stats_plain(*args)),
               **_stats_bound(args)}
        parts.append(res)
        ms += res["ms"]
        call_ms += res["call_ms"]
        plain_ms += res["plain_ms"]
        first_ms += res["first_design_ms"]
        worst = max(worst, err)
        say("kernels", kernel="tile_stats", inputs=f"{path} path call {i}",
            **res)
        del args, got, want, first
    torch.cuda.empty_cache()
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                first_design_ms=first_ms, excluded_rows=excluded,
                **_sum_bounds(parts), max_abs_err=worst,
                mode=f"sum over the {path} path's {len(calls)} calls, its "
                     f"own inputs")


def k3_path_phase(calls, path):
    """K3 on the inputs of a path's own calls, against its float64 plain
    version (rtol 1e-6, SKIP lanes identical) and its first design
    (bitwise); returns the sums over the calls."""
    import torch
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import chisq
    dev = torch.device(DEV)
    ms = call_ms = plain_ms = first_ms = worst = 0.0
    parts = []
    for i, (pv,) in enumerate(calls):
        pv = pv.to(dev)
        got = chisq.fisher_combine(pv)
        want = chisq.fisher_combine_plain(pv)
        first = testing.fisher_combine_first_design(pv)
        torch.cuda.synchronize()
        if not torch.equal(got == -1.0, want == -1.0):
            raise AssertionError(f"fisher_combine, {path} path call {i}: "
                                 f"SKIP lanes differ")
        if not torch.equal(got, first):
            raise AssertionError(f"fisher_combine, {path} path call {i}: "
                                 f"differs from the first design")
        if not _close(got, want, rtol=FISHER_RTOL, atol=0.0):
            raise AssertionError(f"fisher_combine, {path} path call {i}: "
                                 f"outside rtol {FISHER_RTOL}")
        r, n = pv.shape
        err = float((got - want).abs().max())
        res = {"replicates": r, "lanes": n, "max_abs_err": err,
               "kernels_per_call": _kernels_per_call(
                   "fisher_combine", lambda: chisq.fisher_combine(pv),
                   f"{path} path call {i}"),
               "ms": _median_ms(lambda: chisq.fisher_combine(pv)),
               "call_ms": _median_ms(lambda: chisq.fisher_combine(pv),
                                     busy=False),
               "first_design_ms": _median_ms(
                   lambda: testing.fisher_combine_first_design(pv)),
               "plain_ms": _median_ms(
                   lambda: chisq.fisher_combine_plain(pv), n=5),
               **_fisher_bound(pv)}
        parts.append(res)
        ms += res["ms"]
        call_ms += res["call_ms"]
        plain_ms += res["plain_ms"]
        first_ms += res["first_design_ms"]
        worst = max(worst, err)
        say("kernels", kernel="fisher_combine",
            inputs=f"{path} path call {i}", **res)
        del pv, got, want, first
    torch.cuda.empty_cache()
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                first_design_ms=first_ms, **_sum_bounds(parts),
                max_abs_err=worst,
                mode=f"sum over the {path} path's {len(calls)} calls, its "
                     f"own inputs")


def fisher_path(bam_a, bam_b):
    def need(c):
        want = {"coverage_scan": 6, "tile_stats": 6, "fisher_combine": 3}
        bad = {k: c[k] for k, v in want.items() if c[k] != v}
        if bad or c["peak_reduce"] < 3 or c["gap_join"] < 3:
            return (f"launches differ from {want} and peak_reduce, "
                    f"gap_join >= 3")
        return None
    return peak_runs("fisher", f"{bam_a},{bam_b}", need)[0]


NCCL_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextmanager
def one_rank_env():
    """The environment of a one-rank process group on 127.0.0.1 for the
    block (``NCCL_ENV``, a free port)."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    try:
        yield
    finally:
        for k in NCCL_ENV:
            os.environ.pop(k, None)


@contextmanager
def one_rank_nccl():
    """A one-rank process group for the phase, made here from
    ``one_rank_env`` (``init_distributed``: NCCL on the card) before its
    runs, so that the sharded engine and the CLI find it and keep it
    (the CLI leaves only a group that it joined); it is destroyed
    after."""
    import torch.distributed as dist
    from genrich_tpu_torch.parallel.distributed import init_distributed
    with one_rank_env():
        try:
            init_distributed(DEV)
            yield
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def _need_nccl():
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_backend() != "nccl" \
            or dist.get_world_size() != 1:
        raise AssertionError("the sharded engine ran under no one-rank "
                             "NCCL process group")
    return dist.get_backend()


def sharded_path(bam):
    """``--engine sharded`` on the main path under one-rank NCCL against
    the main path's exact file, then K1, K2 and K4 on the inputs of its
    own calls: K1 once per tile from its carry, K2 once per chromosome
    over its [t, M] tiles flattened (padding rows included), K4 once per
    tile (the tiles past a chromosome's end, whose limit is 0, among
    them).  Returns the warm run's counts and the sums of each kernel."""
    from genrich_tpu_torch.ops import peaks, pipeline
    from genrich_tpu_torch.parallel import mesh
    with one_rank_nccl():
        counts, perf = peak_runs("sharded", bam, _need_main,
                                 ["--engine", "sharded"], ref="main")
        backend = _need_nccl()
        calls = kernel_inputs("sharded", bam, [(pipeline, "coverage_scan"),
                                               (mesh, "pileup_runs"),
                                               (mesh, "tile_stats"),
                                               (peaks, "peak_candidates"),
                                               (peaks, "peak_reduce")],
                              ["--engine", "sharded"])
    merge_phase(calls.pop("pileup_runs"), "sharded")
    grid = (perf["grid_tile_len"], perf["grid_tiles"])
    say("sharded_grid", backend=backend, tile_len=grid[0],
        tiles_per_chrom=grid[1], k1_calls=len(calls["coverage_scan"]),
        k2_calls=len(calls["tile_stats"]),
        k4_calls=len(calls["peak_reduce"]),
        straddling_peaks=perf["straddling_peaks"],
        host_peak_chroms=perf["host_peak_chroms"])
    if grid != (1 << 28, 5):
        raise AssertionError(f"sharded grid {grid}, not 5 tiles of 2^28 bp")
    sums = {"coverage_scan": k1_path_phase(calls["coverage_scan"],
                                           "sharded"),
            "tile_stats": k2_path_phase(calls["tile_stats"], "sharded"),
            "gap_join": k5_path_phase(calls["peak_candidates"], "sharded"),
            "peak_reduce": k4_path_phase(calls["peak_reduce"], "sharded")}
    return counts, sums


def sharded_fisher_path(bam_a, bam_b):
    """``-t A,B --engine sharded`` under one-rank NCCL, against the
    Fisher path's exact file, then K3 and K5 on the inputs of its own
    calls (one per tile; K3's on RLEs padded with (limit, SKIP) rows).
    Returns the warm run's counts and K3's and K5's sums."""
    from genrich_tpu_torch.ops import compact, peaks
    with one_rank_nccl():
        counts, perf = peak_runs("sharded_fisher", f"{bam_a},{bam_b}",
                                 _need_every, ["--engine", "sharded"],
                                 ref="fisher")
        _need_nccl()
        calls = kernel_inputs("sharded_fisher", f"{bam_a},{bam_b}",
                              [(compact, "fisher_combine"),
                               (peaks, "peak_candidates")],
                              ["--engine", "sharded"])
    say("sharded_fisher_grid", straddling_peaks=perf["straddling_peaks"],
        host_peak_chroms=perf["host_peak_chroms"],
        k3_calls=len(calls["fisher_combine"]),
        k5_calls=len(calls["peak_candidates"]))
    return counts, k3_path_phase(calls["fisher_combine"], "sharded_fisher"), \
        k5_path_phase(calls["peak_candidates"], "sharded_fisher")


SERVE_LINES = [("jax_cold", "jax"), ("jax_warm", "jax"),
               ("sharded_cold", "sharded"), ("sharded_warm", "sharded"),
               ("bogus", None), ("jax_again", "jax"), ("exact", "exact")]


def serve_phase(bam):
    """A serve child on the main path: statuses, warm bytes against cold
    and against the in-process runs of the same engine, the OK lines'
    JSON, and the walls."""
    run_dir = os.path.join(WORK, "chip_smoke", "serve")
    os.makedirs(run_dir, exist_ok=True)
    lines = []
    for label, engine in SERVE_LINES:
        out = os.path.join(run_dir, f"{label}.np")
        lines.append("bogus --flags" if engine is None else " ".join(
            ["-t", bam, "-o", out] + FLAGS + ["--engine", engine]))
    env = {k: v for k, v in os.environ.items() if k not in NCCL_ENV}
    env["PYTHONPATH"] = REPO
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "genrich_tpu_torch", "--serve",
                        "--device", DEV], input="\n".join(lines) + "\nEXIT\n",
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    child_s = time.perf_counter() - t0
    out = r.stdout.splitlines()
    if r.returncode != 0 or out[:1] != ["READY"]:
        raise AssertionError(f"serve exit code {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    statuses = [ln.split()[0] for ln in out[1:]]
    if statuses != ["OK", "OK", "OK", "OK", "ERR", "OK", "OK"]:
        raise AssertionError(f"serve statuses {statuses}: "
                             f"{r.stderr[-2000:]}")
    walls, perfs = {}, {}
    for (label, engine), ln in zip(SERVE_LINES, out[1:]):
        parts = ln.split(None, 2)
        walls[label] = float(parts[1])
        if engine is None:
            continue
        perfs[label] = json.loads(parts[2])
        keys = ("ingest_s", "findpeaks_s") if engine == "exact" \
            else ("ingest_s", "upload_bytes", "dispatch_n", "fetch_s")
        missing = [k for k in keys if k not in perfs[label]]
        if missing:
            raise AssertionError(f"serve {label}: OK line lacks {missing}")

    def read(path):
        return open(path, "rb").read()
    same = {}
    for engine, in_process in (("jax", "main_port_cold"),
                               ("sharded", "sharded_port_cold"),
                               ("exact", "main_exact")):
        files = [read(os.path.join(run_dir, f"{label}.np"))
                 for label, e in SERVE_LINES if e == engine]
        ref = read(os.path.join(WORK, "chip_smoke", f"{in_process}.np"))
        same[engine] = all(f == files[0] for f in files) and files[0] == ref
        if not same[engine]:
            raise AssertionError(f"serve --engine {engine}: files differ "
                                 f"from each other or the in-process run")
    say("serve", statuses=statuses, child_s=child_s, walls_s=walls,
        equal_to_in_process=same,
        warm_perf={k: perfs[k] for k in ("jax_warm", "sharded_warm",
                                          "exact")})


def logs_path(bam):
    run_dir = os.path.join(WORK, "chip_smoke", "logs")
    out = {}
    for side in ("exact", "port"):
        os.makedirs(os.path.join(run_dir, side), exist_ok=True)

    def path(side, name):
        return os.path.join(run_dir, side, name)
    out["exact"] = {"wall_s": exact_oracle("logs", ["-t", bam] + FLAGS, {
        flag: path("exact", name) for flag, name in (
            ("-o", "out.np"), ("-f", "f.log"), ("-k", "k.log"))})}
    wall, counts, perf, mem = run_port("logs", [
        "-t", bam, "-o", path("port", "out.np"), "-f", path("port", "f.log"),
        "-k", path("port", "k.log")] + FLAGS)
    missing = [k for k in ("coverage_scan", "tile_stats") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"logs: kernels not launched: {missing}")
    out["port"] = {"wall_s": wall, "launches": counts,
                   "max_memory_allocated": mem, "perf": perf}
    from genrich_tpu_torch import testing
    checks = {name: testing.check_log(os.path.join(run_dir, "exact", name),
                                      os.path.join(run_dir, "port", name))
              for name in ("f.log", "k.log")}
    say("logs", pairs=N_LOG_PAIRS, ingest="native", **out, **checks)


# --- ChIP-seq configuration ----------------------------------------------

def chip_flags(bed):
    """Genrich's ChIP-seq flags: no -j, an -E blacklist, -e of a
    chromosome (chr3 stands in for chrM) and the default -p 0.01."""
    return ["-r", "-p", "0.01", "-a", "20", "-E", bed, "-e", "chr3"]


CHIP_THRESH = 2.0                                 # -log10(0.01)
CHIP_CAP = 256          # chip_capped's slots a chromosome (TorchEngine)
CHIP_TILE_CAP = 64      # and a tile (the sharded engine)


def write_blacklist():
    """blk.bed (``testing.blacklist_regions``, seed 10): 1,000 regions of
    1-50 kb on chr1 and chr2 with overlapping and adjacent pairs, one
    across each 2^28-bp tile boundary, one ending at chr1's end, and one
    from the midpoint of the strongest peak of chr1 and of chr2 in the
    main path's exact file (a perf_synth hotspot) on.  Returns its path
    and those midpoints."""
    from genrich_tpu_torch.bench import HG_CHROMS
    from genrich_tpu_torch import testing
    run_dir = os.path.join(WORK, "chip_smoke")
    rows = [ln.split("\t") for ln in open(os.path.join(
        run_dir, "main_exact.np")).read().splitlines()]
    cut = []
    for name in ("chr1", "chr2"):
        top = max((r for r in rows if r[0] == name),
                  key=lambda r: float(r[6]))
        cut.append((name, (int(top[1]) + int(top[2])) // 2))
    regions = testing.blacklist_regions(
        np.random.RandomState(10), HG_CHROMS[:2], 1000, (1_000, 50_000),
        1 << 28, cut=cut)
    path = testing.write_bed(os.path.join(run_dir, "blk.bed"), regions)
    say("blacklist", regions=len(regions), cut=cut,
        bp=sum(e - s for _, s, e in regions))
    return path, cut


def path_kernels(calls, path):
    """Each kernel on the inputs of a path's own calls, held as on the
    main path's (K2 also counts the excluded rows it read); returns
    {kernel: sums}."""
    phase = {"coverage_scan": k1_path_phase, "tile_stats": k2_path_phase,
             "fisher_combine": k3_path_phase, "peak_candidates":
             k5_path_phase, "peak_reduce": k4_path_phase}
    names = {"peak_candidates": "gap_join"}
    return {names.get(k, k): phase[k](c, path) for k, c in calls.items()}


def _chip_targets(sharded):
    from genrich_tpu_torch.engine import torch_bridge
    from genrich_tpu_torch.ops import compact, peaks, pipeline
    from genrich_tpu_torch.parallel import mesh
    return [(pipeline, "coverage_scan"),
            (mesh if sharded else compact, "pileup_runs"),
            (mesh if sharded else torch_bridge, "tile_stats"),
            (peaks, "peak_candidates"), (peaks, "peak_reduce")]


def chip_path(name, bam_t, bam_c, flags, sharded=False):
    """``-t bam_t -c bam_c`` with the ChIP flags: the exact engine
    (once, on TorchEngine's run), the port cold and warm, then K1, the
    merge, K2 (on rows with excluded flags: none is a fault), K5 and K4
    on the inputs of its own calls.  Returns the warm run's counts and
    perf and each kernel's sums."""
    extra = ["-c", bam_c] + (["--engine", "sharded"] if sharded else [])
    counts, perf = peak_runs(name, bam_t, _need_main, extra,
                             ref="chip" if sharded else None, flags=flags,
                             thresh=CHIP_THRESH)
    if sharded:
        _need_nccl()
    calls = kernel_inputs(name, bam_t, _chip_targets(sharded), extra, flags)
    merge_phase(calls.pop("pileup_runs"), name)
    sums = path_kernels(calls, name)
    say(f"{name}_excluded", k2_calls=len(calls["tile_stats"]),
        excluded_rows=sums["tile_stats"]["excluded_rows"],
        peak_redispatch=perf["peak_redispatch"],
        host_peak_chroms=perf["host_peak_chroms"])
    if sums["tile_stats"]["excluded_rows"] == 0:
        raise AssertionError(f"{name}: K2 read no excluded row")
    return counts, perf, sums


def chip_fisher_path(name, bams_t, bam_c, flags, sharded=False):
    """``-t A,B -c C,C`` with the ChIP flags: the port's exact engine
    is the oracle, then the port cold and warm, then K1, the merge, K2
    (on rows
    with excluded flags: none is a fault), K3 over the controlled
    replicates, K5 and K4 on the inputs of its own calls."""
    from genrich_tpu_torch.ops import compact
    extra = ["-c", f"{bam_c},{bam_c}"] \
        + (["--engine", "sharded"] if sharded else [])
    counts, perf = peak_runs(name, bams_t, _need_every, extra,
                             ref="chip_fisher" if sharded else None,
                             flags=flags, thresh=CHIP_THRESH)
    if sharded:
        _need_nccl()
    calls = kernel_inputs(name, bams_t, _chip_targets(sharded)
                          + [(compact, "fisher_combine")], extra, flags)
    merge_phase(calls.pop("pileup_runs"), name)
    sums = path_kernels(calls, name)
    say(f"{name}_excluded", k2_calls=len(calls["tile_stats"]),
        excluded_rows=sums["tile_stats"]["excluded_rows"])
    if sums["tile_stats"]["excluded_rows"] == 0:
        raise AssertionError(f"{name}: K2 read no excluded row")
    return counts, perf, sums


def chip_capped_path(name, bam_t, bam_c, flags, sharded=False):
    """The chip run once more in this process with the candidate slots
    cut (TorchEngine's ``PEAK_CAP`` to 256 a chromosome, the sharded
    engine's to 64 a tile, monkeypatched as a test does): the bytes of
    the uncapped cold run, no host peak caller, at least one re-dispatch;
    every K5 and K4 call counted (``LAUNCHES``), and the re-dispatched
    calls (more slots than the cap) held to their plain versions with
    their kernels read by graph capture.  Returns the counts and the
    re-dispatched calls' sums."""
    from genrich_tpu_torch.engine import sharded_bridge, torch_bridge
    from genrich_tpu_torch.ops import peaks
    from genrich_tpu_torch.testing import recording
    mod = sharded_bridge if sharded else torch_bridge
    cap = CHIP_TILE_CAP if sharded else CHIP_CAP
    run_dir = os.path.join(WORK, "chip_smoke")
    out_np = os.path.join(run_dir, f"{name}.np")
    extra = ["-c", bam_c] + (["--engine", "sharded"] if sharded else [])
    real_cap = mod.PEAK_CAP
    mod.PEAK_CAP = cap
    try:
        with recording([(peaks, "peak_candidates"),
                        (peaks, "peak_reduce")]) as calls:
            wall, counts, perf, mem = run_port(
                name, ["-t", bam_t, "-o", out_np, *extra] + flags)
    finally:
        mod.PEAK_CAP = real_cap
    ref = "chip_sharded_port_cold.np" if sharded else "chip_port_cold.np"
    same = open(out_np, "rb").read() == open(os.path.join(run_dir, ref),
                                             "rb").read()
    again = {"peak_candidates": [c for c in calls["peak_candidates"]
                                 if c[6] > cap],
             "peak_reduce": [c for c in calls["peak_reduce"]
                             if c[6].shape[0] > cap]}
    say(name, wall_s=wall, launches=counts, max_memory_allocated=mem,
        cap=cap, equal_to_uncapped=same,
        peak_redispatch=perf["peak_redispatch"],
        host_peak_chroms=perf["host_peak_chroms"],
        k5_calls=len(calls["peak_candidates"]),
        k5_redispatched=len(again["peak_candidates"]),
        redispatch_slots=sorted({int(c[6]) for c
                                 in again["peak_candidates"]}), perf=perf)
    tiles = perf["grid_tiles"] if sharded else 1
    if not same:
        raise AssertionError(f"{name}: bytes differ from the uncapped run")
    if perf["host_peak_chroms"] or perf["peak_redispatch"] <= 0:
        raise AssertionError(f"{name}: {perf['peak_redispatch']} "
                             f"re-dispatches, {perf['host_peak_chroms']} "
                             f"host chromosomes")
    for kernel, name_ in (("gap_join", "peak_candidates"),
                          ("peak_reduce", "peak_reduce")):
        if counts[kernel] != len(calls[name_]) or len(again[name_]) \
                != perf["peak_redispatch"] * tiles:
            raise AssertionError(f"{name}: {counts[kernel]} {kernel} "
                                 f"launches for {len(calls[name_])} calls, "
                                 f"{len(again[name_])} re-dispatched")
    return counts, path_kernels(again, f"{name} re-dispatch")


def chip_phases(bam_a, bam_b, bam_c):
    """The ChIP-seq configuration through both device engines: chip,
    chip_fisher (a third BAM, 1M pairs, seed 9, the replicates'
    control) and chip_capped; returns {path: counts} and {path: {kernel:
    sums}}."""
    bed, cut = write_blacklist()
    flags = chip_flags(bed)
    counts, sums = {}, {}

    def keep(path, res):
        counts[path], _, sums[path] = res
    keep("chip", chip_path("chip", bam_a, bam_b, flags))
    cut_ends = {(n, e) for n, e in ((ln.split("\t")[0],
                int(ln.split("\t")[2])) for ln in open(os.path.join(
                    WORK, "chip_smoke", "chip_exact.np")))}
    ends_at = [c for c in cut if tuple(c) in cut_ends]
    say("chip_cut", cut=cut, peaks_ending_at_a_cut=ends_at)
    if len(ends_at) < len(cut):
        raise AssertionError(f"chip: no exact peak ends at the blacklist "
                             f"cuts {[c for c in cut if c not in ends_at]}")
    keep("chip_fisher", chip_fisher_path("chip_fisher", f"{bam_a},{bam_b}",
                                         bam_c, flags))
    counts["chip_capped"], sums["chip_capped"] = chip_capped_path(
        "chip_capped", bam_a, bam_b, flags)
    with one_rank_nccl():
        keep("chip_sharded", chip_path("chip_sharded", bam_a, bam_b, flags,
                                       sharded=True))
        keep("chip_fisher_sharded", chip_fisher_path(
            "chip_fisher_sharded", f"{bam_a},{bam_b}", bam_c, flags,
            sharded=True))
        counts["chip_capped_sharded"], sums["chip_capped_sharded"] = \
            chip_capped_path("chip_capped_sharded", bam_a, bam_b, flags,
                             sharded=True)
    return counts, sums


# --- the bench ---------------------------------------------------------------

def _hold_tile_peaks(got, want, where):
    """A tile's peaks on the card (``got``) against the same tile through
    the plain versions on the CPU (``want``): the same valid peaks, their
    starts, ends and summit offsets equal, AUC and summit p within
    rtol 1e-5 (K4 sums in float32 row order, the plain version as a
    float64 prefix difference; K1's -log10 p within 1e-5)."""
    import torch
    gv, wv = got.valid.cpu(), want.valid
    if not torch.equal(gv, wv):
        raise AssertionError(f"bench {where} tile: valid peaks differ "
                             f"({int(gv.sum())} / {int(wv.sum())})")
    for name in ("start", "end", "summit_pos"):
        if not torch.equal(getattr(got, name).cpu()[gv],
                           getattr(want, name)[wv]):
            raise AssertionError(f"bench {where} tile: peak {name} differs")
    for name in ("auc", "summit_pval"):
        if not _close(getattr(got, name).cpu()[gv], getattr(want, name)[wv],
                      atol=0.0):
            raise AssertionError(f"bench {where} tile: peak {name} beyond "
                                 f"rtol {TOL}")
    return int(gv.sum())


def bench_phase(bam_a):
    """``python -m genrich_tpu_torch.bench --kernel-only --reps 1`` in this
    process (the bench path's launches counted), one light and one
    production tile of it held to their plain versions (K1's coverage
    bitwise and its lambda-mode -log10 p within rtol = atol = 1e-5, K2,
    K5 and K4 as on the main path's calls, each call's kernels read by
    graph capture; the tiles' peaks against the same tiles through the
    plain versions on the CPU), and the bench's ``atac`` end-to-end leg
    with one rep on ``--engine jax`` (its serve output must be the main
    path's bytes).  Returns the counts and each kernel's sums."""
    import torch
    from genrich_tpu_torch import bench, kernels
    from genrich_tpu_torch.ops import scan
    from genrich_tpu_torch.testing import recording
    t0 = time.perf_counter()
    detail = os.path.join(WORK, "chip_smoke", "bench_detail.json")
    kernels.reset_launches()
    line = io.StringIO()
    with contextlib.redirect_stdout(line):
        rc = bench.main(["--kernel-only", "--reps", "1", "--out", detail])
    counts = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"bench --kernel-only: exit code {rc}")
    fault = _need_main(counts)
    if fault:
        raise AssertionError(f"bench: {fault}: {counts}")
    head = json.loads(line.getvalue().splitlines()[-1])
    with open(detail) as f:
        legs = json.load(f)
    dev = torch.device(DEV)
    one = [torch.as_tensor(a, device=dev)
           for a in bench._tile_events(np.random.RandomState(0))[0]]
    lam = bench.tile_lambda(bench.TILE_LEN, bench.EVENTS_PER_TILE)
    zero4 = torch.zeros(4, dtype=torch.int32, device=dev)
    excl = bench.prod_excl(bench.TILE_LEN, dev)
    cpu = [t.cpu() for t in one]
    tiles = {}
    for where, tile in (
            ("light", lambda ev, ex, z: bench.light_tile(
                *ev, bench.TILE_LEN, lam, z)),
            ("production", lambda ev, ex, z: bench.prod_tile(
                *ev, ex, bench.TILE_LEN, lam, z)[0])):
        with recording(bench.KERNEL_TARGETS) as calls:
            got = tile(one, excl, zero4)
        want = tile(cpu, excl.cpu(), zero4.cpu())
        tiles[where] = (calls, _hold_tile_peaks(got.peaks, want.peaks,
                                                where))
    light = tiles["light"][0]
    packed, groups, carry, lam_k = light["coverage_scan"][0]
    got = scan.coverage_scan(packed.to(dev), groups, carry.to(dev), lam_k)
    want = scan.coverage_scan_plain(packed, groups, carry, lam_k)
    p_err = float((got[1].cpu() - want[1]).abs().max())
    if not (torch.equal(got[0].cpu(), want[0])
            and _close(got[1].cpu(), want[1])):
        raise AssertionError(f"coverage_scan, bench light tile: coverage "
                             f"not bitwise or -log10 p max abs err {p_err}")
    del got, want
    k1 = {where: k1_path_phase(calls["coverage_scan"], f"bench {where}")
          for where, (calls, _) in tiles.items()}
    sums = {"coverage_scan": dict(k1["production"]),
            "tile_stats": k2_path_phase(
                tiles["production"][0]["tile_stats"], "bench production"),
            "gap_join": k5_path_phase(
                [c for calls, _ in tiles.values()
                 for c in calls["peak_candidates"]], "bench"),
            "peak_reduce": k4_path_phase(
                [c for calls, _ in tiles.values()
                 for c in calls["peak_reduce"]], "bench")}
    for key in ("ms", "call_ms", "plain_ms", "first_design_ms"):
        sums["coverage_scan"][key] += k1["light"][key]
    sums["coverage_scan"].update(_sum_bounds([k1["light"],
                                              k1["production"]]))
    sums["coverage_scan"]["mode"] = "sum over the bench's light (lambda " \
        "mode) and production tile's calls; one kernel launch per call"
    k1["light"]["p_max_abs_err"] = p_err
    e2e = bench.bench_e2e({"A": bam_a}, ["atac"], 1, DEV, engines=("jax",),
                          work=WORK, par_leg=False)
    atac = e2e["configs"]["atac"]
    same = open(os.path.join(WORK, "bench_e2e", "atac_jax_cold.np"),
                "rb").read() == open(os.path.join(
                    WORK, "chip_smoke", "main_port_cold.np"), "rb").read()
    say("bench", seconds=time.perf_counter() - t0, headline=head,
        launches=counts, per_tile_ms=legs["kernel"]["per_tile_ms_batched"],
        per_tile_ms_production=legs["kernel_production"]["per_tile_ms"],
        host_syncs_per_dispatch=[legs[k]["host_syncs_per_dispatch"] for k
                                 in ("kernel", "kernel_production")],
        peaks={k: n for k, (_, n) in tiles.items()},
        lambda_p_max_abs_err=p_err, e2e_ok=e2e["ok"],
        e2e_checks=atac["checks"], e2e_exact_s=atac["exact"]["median_s"],
        e2e_jax=atac["jax"], equal_to_main_path=same)
    if not e2e["ok"] or not same:
        raise AssertionError(f"bench atac leg: checks {atac['checks']}, "
                             f"equal to the main path's bytes: {same}")
    return counts, sums, k1["light"]


# --- the sharded engine over every card -------------------------------------

# md5 of each path's narrowPeak on every device engine (one card), as
# PERF.md records them
RECORDED_MD5 = {"main": "1e5d8a6750aa937e48894003dd79f644",
                "chip_fisher": "2aa2ffbacf1e7c6d96266eee9563a21b"}


def _card_run(label, args, engine=None):
    """One port run of ``args`` with the counts set to 0 just before it
    and read just after: through ``cli.main`` (``args`` name the engine
    and device), or with ``engine`` through ``pipeline.run``.  Returns
    (wall, per-card launches, perf, per-card peak memory)."""
    from genrich_tpu_torch import cli, kernels, pipeline
    from genrich_tpu_torch.engine import perf as eperf
    perf = {}
    eperf.synchronize_cards()
    eperf.reset_peak_memory()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if engine is None:
        rc = cli.main(args, perf=perf)
    else:
        engine.begin_run()
        pipeline.run(cli.parse_port_args(args), engine=engine, perf=perf)
        rc = 0
    eperf.synchronize_cards()
    wall = time.perf_counter() - t0
    cards = {i: dict(c) for i, c in kernels.CARD_LAUNCHES.items()}
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    if not _native_used():
        raise AssertionError(f"{label} used Python ingest")
    return wall, cards, perf, eperf.peak_memory()


def _one_card_refs(name, args):
    """TorchEngine's and the one-card sharded engine's files of a path
    (phases 4, 7, 11 and 12 wrote them; made here on cuda:0 when this
    phase runs alone)."""
    run_dir = os.path.join(WORK, "chip_smoke")
    refs = {"torch": f"{name}_port_cold.np",
            "one_card": ("sharded_port_cold.np" if name == "main"
                         else f"{name}_sharded_port_cold.np")}
    for kind, fname in refs.items():
        path = refs[kind] = os.path.join(run_dir, fname)
        if not os.path.exists(path):
            engine = "jax" if kind == "torch" else "sharded"
            _card_run(f"{name} {kind}", args + [
                "-o", path, "--engine", engine, "--device", "cuda:0"])
    return refs


def _hold_output(where, name, path, want, perf, cards, used, need, zero):
    """The gates of phases 14 and 15 on the output ``path`` of path
    ``name``: the recorded md5 and the bytes of TorchEngine and of the
    one-card sharded engine (``want``), no host peak call, and
    ``need``'s kernels launched on every card of ``used``
    (``cards``: launches by card).  Returns the md5."""
    got, md5 = open(path, "rb").read(), _md5(path)
    if md5 != RECORDED_MD5[name] or got != want["torch"] \
            or got != want["one_card"]:
        raise AssertionError(f"{where}: md5 {md5}, not the recorded bytes")
    if perf["host_peak_chroms"]:
        raise AssertionError(f"{where}: the host peak caller ran")
    faults = {i: need({**zero, **cards.get(i, {})}) for i in used}
    faults = {i: f for i, f in faults.items() if f}
    if faults:
        raise AssertionError(f"{where}: {faults}: {cards}")
    return md5


def sharded_cards_phase(bam_a, bam_b, bam_c, bed):
    """``--engine sharded`` with no process group over every card of the
    machine (``--device cuda``), cold and warm, then once over two
    contexts on cuda:0 (``ShardedTorchEngine(["cuda:0", "cuda:0"])``:
    on one card the in-process collectives still run), on the main
    path's BAM and flags and on ``chip_fisher``.  Each output must have
    the recorded md5 and equal TorchEngine's and the one-card sharded
    engine's bytes; no chromosome may go to the host peak caller; each
    card must launch K1, K2, K5 and K4 (and K3 on ``chip_fisher``).
    Prints the card count, each run's wall, launches and peak memory
    per card.  Returns the main path's cold launches, summed over the
    cards."""
    import torch
    from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
    from genrich_tpu_torch import kernels
    n_cards = torch.cuda.device_count()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    run_dir = os.path.join(WORK, "chip_smoke", "sharded_cards")
    os.makedirs(run_dir, exist_ok=True)
    paths = [("main", ["-t", bam_a] + FLAGS, _need_main),
             ("chip_fisher", ["-t", f"{bam_a},{bam_b}", "-c",
                              f"{bam_c},{bam_c}"] + chip_flags(bed),
              _need_every)]
    main_counts = None
    for name, args, need in paths:
        refs = _one_card_refs(name, args)
        want = {k: open(p, "rb").read() for k, p in refs.items()}
        for label in ("cold", "warm", "two_contexts"):
            out = os.path.join(run_dir, f"{name}_{label}.np")
            if label == "two_contexts":
                engine = ShardedTorchEngine(["cuda:0", "cuda:0"])
                wall, cards, perf, mem = _card_run(
                    f"{name} {label}", args + ["-o", out], engine)
                shards = engine.world
                engine.release()
            else:
                wall, cards, perf, mem = _card_run(
                    f"{name} {label}", args + ["-o", out, "--engine",
                                               "sharded", "--device",
                                               "cuda"])
                shards = n_cards
            got = open(out, "rb").read()
            say(f"sharded_cards_{name}_{label}", cards=n_cards,
                shards=shards, wall_s=wall, md5=_md5(out),
                recorded_md5=RECORDED_MD5[name],
                equal_to_torch_engine=got == want["torch"],
                equal_to_one_card=got == want["one_card"],
                launches_by_card=cards, max_memory_allocated_by_card=mem,
                host_peak_chroms=perf["host_peak_chroms"],
                grid=(perf["grid_tile_len"], perf["grid_tiles"]),
                straddling_peaks=perf["straddling_peaks"],
                fetch_n=perf["fetch_n"], dispatch_n=perf["dispatch_n"],
                ingest_s=perf.get("ingest_s"),
                device_rep_s=perf.get("device_rep_s"),
                findpeaks_s=perf.get("findpeaks_s"))
            _hold_output(f"sharded_cards {name} {label}", name, out, want,
                         perf, cards, [0] if label == "two_contexts"
                         else range(n_cards), need, zero)
            if name == "main" and label == "cold":
                main_counts = {k: sum(c[k] for c in cards.values())
                               for k in zero}
    return main_counts


def rank_run(label, argv, devices=None, profiled=False):
    """One run of phase 15 in this process, with the counts and peak
    memory set to 0 just before it and read just after: the CLI with
    ``--engine sharded --device cuda`` (``devices`` None) or
    ``ShardedTorchEngine(devices)`` through ``pipeline.run``; with
    ``profiled`` under torch.profiler.  Returns its record: wall,
    launches and peak memory per card, perf, the process group's rank
    and size, native ingest, the modules of jax or genrich_tpu loaded
    (none may be) and, profiled, device ms per card and their part in
    NCCL's kernels and in copies between cards and on a card."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from genrich_tpu_torch import cli, kernels, pipeline
    from genrich_tpu_torch import prof as gprof
    from genrich_tpu_torch.engine import perf as eperf
    from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
    perf = {}
    eperf.synchronize_cards()
    eperf.reset_peak_memory()
    kernels.reset_launches()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if profiled else contextlib.nullcontext()) as pr:
        t0 = time.perf_counter()
        if devices is None:
            rc = cli.main(argv + ["--engine", "sharded", "--device", "cuda"],
                          perf=perf)
        else:
            p = cli.parse_port_args(argv)
            cli.native_ingest(p)
            engine = ShardedTorchEngine(devices)
            pipeline.run(p, engine=engine, perf=perf)
            engine.release()
            rc = 0
        eperf.synchronize_cards()
        wall = time.perf_counter() - t0
    mem = eperf.peak_memory()
    cards = {i: dict(c) for i, c in kernels.CARD_LAUNCHES.items()}
    rec = {"label": label, "rc": rc, "wall_s": wall,
           "rank": dist.get_rank(), "ranks": dist.get_world_size(),
           "native": _native_used(), "launches_by_card": cards,
           "max_memory_allocated_by_card": {i: mem[i] for i in cards
                                            if i < len(mem)},
           "perf": {k: perf.get(k) for k in (
               "host_peak_chroms", "grid_tile_len", "grid_tiles",
               "straddling_peaks", "fetch_n", "dispatch_n", "ingest_s",
               "device_rep_s", "findpeaks_s")},
           "loaded": sorted({m.split(".")[0] for m in sys.modules}
                            & {"jax", "genrich_tpu"})}
    if profiled:
        rec["device_ms_by_card"] = gprof._device_ms_by_card(pr)
        rec["comm_ms_by_card"] = gprof.comm_ms_by_card(pr)
    return rec


def rank_child(cfg):
    """A rank child of phase 15: joins the process group from the
    environment itself (so that the CLI keeps it across the runs), then
    ``rank_run`` of each of ``cfg["runs"]`` ([label, argv, profiled];
    "{rank}" in an argument is this rank) over ``cfg["devices"]``, one
    JSON line each, then destroys the group."""
    import torch.distributed as dist
    from genrich_tpu_torch.parallel.distributed import init_distributed
    init_distributed(cfg["devices"] or DEV)
    for label, argv, profiled in cfg["runs"]:
        argv = [a.replace("{rank}", os.environ["RANK"]) for a in argv]
        print(json.dumps(rank_run(label, argv, cfg["devices"], profiled)),
              flush=True)
    dist.destroy_process_group()


# A rank child of phase 15: argv is the repo and its settings as JSON.
_RANK_CHILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
               "import chip_smoke; "
               "chip_smoke.rank_child(json.loads(sys.argv[2]))")


def _rank_children(runs, cli_form):
    """Two NCCL ranks, one child process each, running ``runs``: on four
    cards or more the CLI with ``--engine sharded --device cuda``,
    ``LOCAL_WORLD_SIZE=2`` and ``LOCAL_RANK=r`` (each rank half the
    cards; ``cli_form``), otherwise ``ShardedTorchEngine([f"cuda:{r}"]
    * 2)`` through ``pipeline.run``.
    Returns each run's records, one a rank; a child that fails fails
    the phase."""
    env = {k: v for k, v in os.environ.items() if k not in NCCL_ENV}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    procs = []
    for r in (0, 1):
        extra = {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(r)} \
            if cli_form else {}
        cfg = {"devices": None if cli_form else [f"{DEV}:{r}"] * 2,
               "runs": runs}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_CHILD, REPO, json.dumps(cfg)],
            env={**env, **extra, "RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"sharded_ranks rank {r}: exit code "
                                 f"{p.returncode}: {err[-3000:]}")
    recs = [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
            for out, _ in logs]
    if any(len(rs) != len(runs) for rs in recs):
        raise AssertionError(f"sharded_ranks: {[len(rs) for rs in recs]} "
                             f"records for {len(runs)} runs")
    return [list(rec) for rec in zip(*recs)]


def _hold_rank_runs(form, label, out, recs, want, need, used, zero):
    """The gates of phase 15 on one run's records, one a rank, each rank
    having written ``out`` with "{rank}" its rank: exit code 0, the
    group's size and rank, native ingest, no jax or genrich_tpu,
    ``_hold_output`` on each rank's file and cards, and launches on
    every card of ``used`` and on no other.  Prints the run's line;
    returns the launches by card."""
    name = label.split()[0]
    every = {}
    for r, rec in enumerate(recs):
        where = f"sharded_ranks {form} {label} rank {r}"
        if rec["rc"] != 0 or rec["ranks"] != len(recs) or rec["rank"] != r:
            raise AssertionError(f"{where}: {rec}")
        if not rec["native"] or rec["loaded"]:
            raise AssertionError(f"{where}: Python ingest or "
                                 f"{rec['loaded']}")
        cards = {int(i): c for i, c in rec["launches_by_card"].items()}
        md5 = _hold_output(where, name, out.replace("{rank}", str(r)), want,
                           rec["perf"], cards, cards, need, zero)
        every.update(cards)
    if set(every) != used:
        raise AssertionError(f"sharded_ranks {form} {label}: launches on "
                             f"cards {sorted(every)}, not {sorted(used)}")
    line = {"form": form, "ranks": len(recs), "cards": len(used),
            "md5": md5, "wall_s": [rec["wall_s"] for rec in recs],
            "device_rep_s": [rec["perf"]["device_rep_s"] for rec in recs],
            "ingest_s": [rec["perf"]["ingest_s"] for rec in recs],
            "launches_by_card": every,
            "max_memory_allocated_by_card": {
                i: m for rec in recs
                for i, m in rec["max_memory_allocated_by_card"].items()},
            "grid": [recs[0]["perf"]["grid_tile_len"],
                     recs[0]["perf"]["grid_tiles"]],
            "straddling_peaks": recs[0]["perf"]["straddling_peaks"]}
    for key in ("device_ms_by_card", "comm_ms_by_card"):
        if key in recs[0]:
            line[key] = {i: v for rec in recs for i, v in rec[key].items()}
    say(f"sharded_ranks_{form}_{label.replace(' ', '_')}", **line)
    return every


# what the stderr of a rank of the CLI must not hold: an abort at exit,
# a group that the process never left (PyTorch's two wordings), a crash
UNCLEAN = ("terminate called", "has NOT been destroyed",
           "destroy_process_group() was not called", "Fatal Python error",
           "Traceback")


def leave_ms(reps=5):
    """The wall of ``scoped_group``'s leave of a one-rank process group
    that its block joined from the environment (NCCL on the card) after
    one collective: the barrier and ``destroy_process_group``, ms, each
    of ``reps`` in this process."""
    import torch
    import torch.distributed as dist
    from genrich_tpu_torch.parallel.distributed import (init_distributed,
                                                        scoped_group)
    walls = []
    for _ in range(reps):
        with one_rank_env(), scoped_group():
            init_distributed(DEV)
            dist.all_reduce(torch.ones(1, device=f"{DEV}:0"))
            t0 = time.perf_counter()
        walls.append((time.perf_counter() - t0) * 1e3)
        if dist.is_initialized():
            raise AssertionError("scoped_group left its group up")
    return walls


def cli_ranks(n, name, args, want, run_dir):
    """``python -m genrich_tpu_torch ... --engine sharded --device cuda``
    itself as ``n`` NCCL ranks, a process of its own each, on card
    ``RANK`` (one card a rank): the CLI joins the group from
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK and leaves it.  Every
    rank must exit with 0 and an output free of ``UNCLEAN``, and write
    the bytes of path ``name`` on one card (``want``, the recorded
    md5).  Prints the exit codes, each rank's wall and its teardown:
    from its narrowPeak's last write (the file's mtime, a few ms
    coarse) to its exit as seen here, interpreter and CUDA teardown
    included."""
    env = {k: v for k, v in os.environ.items()
           if k not in NCCL_ENV + ("LOCAL_WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), PYTHONPATH=REPO)
    outs = [os.path.join(run_dir, f"{name}_cli_{n}_r{r}.np")
            for r in range(n)]
    logs = [os.path.join(run_dir, f"{name}_cli_{n}_r{r}.log")
            for r in range(n)]
    procs = []
    t0 = time.time()
    for r in range(n):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "genrich_tpu_torch"] + args
                + ["-o", outs[r], "--engine", "sharded", "--device", DEV],
                env={**env, "RANK": str(r)}, cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT))
    ended = [None] * n
    try:
        while None in ended:
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.time()
            if time.time() - t0 > 400:
                raise AssertionError(f"sharded_ranks cli {n} {name}: "
                                     f"ranks still running after 400 s")
            time.sleep(0.001)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    text = [open(log).read() for log in logs]
    for r in range(n):
        where = f"sharded_ranks cli {n} {name} rank {r}"
        marks = [m for m in UNCLEAN if m in text[r]]
        if rcs[r] != 0 or marks:
            raise AssertionError(f"{where}: exit code {rcs[r]}, {marks}: "
                                 f"{text[r][-3000:]}")
        got = open(outs[r], "rb").read()
        if _md5(outs[r]) != RECORDED_MD5[name] or got != want["torch"] \
                or got != want["one_card"]:
            raise AssertionError(f"{where}: md5 {_md5(outs[r])}, not the "
                                 f"one-card bytes")
    say(f"sharded_ranks_cli_{n}_{name}", ranks=n, exit_codes=rcs,
        wall_s=[e - t0 for e in ended],
        teardown_ms=[(e - os.stat(o).st_mtime) * 1e3
                     for e, o in zip(ended, outs)],
        md5=_md5(outs[0]), output_bytes=[len(t) for t in text])


def sharded_ranks_phase(bam_a, bam_b, bam_c, bed):
    """Several shards a rank of an NCCL group, on the main path's BAM and
    flags and on ``chip_fisher``, cold and warm (and main once more
    under torch.profiler): one rank of two contexts on cuda:0
    (``ShardedTorchEngine(["cuda:0", "cuda:0"])`` under a one-rank
    group) on any machine, and with two cards or more two rank children
    (``_rank_children``).  Every run is held by ``_hold_rank_runs``.
    Then the wall of leaving a one-rank group (``leave_ms``), and the
    CLI itself as NCCL rank processes on both paths (``cli_ranks``): one
    rank on any machine, and two ranks of one card each with two cards
    or more.  Returns the main path's cold launches of its widest form
    (the children's, else the one rank's), summed over the cards."""
    import torch
    from genrich_tpu_torch import kernels
    n_cards = torch.cuda.device_count()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    run_dir = os.path.join(WORK, "chip_smoke", "sharded_ranks")
    os.makedirs(run_dir, exist_ok=True)
    paths = {"main": (["-t", bam_a] + FLAGS, _need_main),
             "chip_fisher": (["-t", f"{bam_a},{bam_b}", "-c",
                              f"{bam_c},{bam_c}"] + chip_flags(bed),
                             _need_every)}
    wants = {name: {k: open(p, "rb").read() for k, p in
                    _one_card_refs(name, args).items()}
             for name, (args, _) in paths.items()}

    def runs(form):
        return [[f"{name} {label}", args + ["-o", os.path.join(
            run_dir, f"{name}_{form}_{label}_r{{rank}}.np")],
            label == "profiled"]
            for name, (args, _) in paths.items()
            for label in ("cold", "warm") + (("profiled",) if name == "main"
                                             else ())]

    forms = [("one_rank", {0}, None)]
    if n_cards >= 2:
        cli_form = n_cards >= 4 and n_cards % 2 == 0
        forms.append(("two_ranks", set(range(n_cards)) if cli_form
                      else {0, 1}, cli_form))
    else:
        say("sharded_ranks_two_ranks", skipped="one card: NCCL takes no "
            "two ranks on one card")
    counts = None
    for form, used, cli_form in forms:
        if form == "one_rank":
            with one_rank_nccl():
                recs = []
                for label, argv, profiled in runs(form):
                    recs.append([rank_run(label, [
                        a.replace("{rank}", "0") for a in argv],
                        [f"{DEV}:0"] * 2, profiled)])
                    _need_nccl()
        else:
            recs = _rank_children(runs(form), cli_form)
        for (label, argv, _), rs in zip(runs(form), recs):
            every = _hold_rank_runs(form, label, argv[-1], rs,
                                    wants[label.split()[0]],
                                    paths[label.split()[0]][1], used, zero)
            if label == "main cold":
                counts = {k: sum(c[k] for c in every.values()) for k in zero}
    say("sharded_ranks_leave", one_rank_leave_ms=leave_ms())
    for n in (1, 2) if n_cards >= 2 else (1,):
        for name, (args, _) in paths.items():
            cli_ranks(n, name, args, wants[name], run_dir)
    if n_cards < 2:
        say("sharded_ranks_cli_2", skipped="one card: NCCL takes no two "
            "ranks on one card")
    return counts


T0 = time.perf_counter()
T0 = time.perf_counter()


# --- the ladder's 10M rung -------------------------------------------------

def _largest(calls, name):
    """The call of ``name`` with the most rows: the largest chromosome's."""
    return max(calls[name], key=lambda c: c[0].shape[0])


def _k2_tables(args):
    """K2's rows on a call: those it reads from its tables (``table_p``,
    ``table_params``), those that run the arithmetic in full beyond them,
    and of those the integral values at or above ``testing.STATS_TABLE``."""
    from genrich_tpu_torch import testing
    c = testing.tile_stats_opcount(*args)
    b = c["branches"]
    expt = args[0]
    integral = (expt >= testing.STATS_TABLE) & (expt.trunc() == expt) \
        & ~args[2]
    return {"rows": c["rows"], "main": b["main"], "table_p": b["table_p"],
            "table_params": b["table_params"],
            "beyond_tables": b["main"] - b["table_p"] - b["table_params"],
            "integral_at_or_above_table": int(integral.sum()),
            "max_expt": float(expt.max())}


def _raised_past_tables(call, stride=40, top=33_290):
    """K2's call ``call`` with every ``stride``-th row's coverage raised
    to an integral value from ``testing.STATS_TABLE`` to ``top`` (the
    most the 60M rung's largest call held), so that its beyond-table
    branch runs on the rows, lambdas and exclusions of a real call: the
    10M rung's own coverage stays below the tables."""
    import torch
    from genrich_tpu_torch import testing
    expt = call[0].clone()
    idx = torch.arange(0, expt.shape[0], stride, device=expt.device)
    span = top - testing.STATS_TABLE + 1
    expt[idx] = (testing.STATS_TABLE + (idx * 7) % span).to(expt.dtype)
    return [expt] + list(call[1:])


def ladder_phase(bam):
    """Phase 16: the 10M rung of ``bench --mem`` (``bench.mem_rung``, one
    rep: the exact child, then the cold and a warm line of a serve child
    per device engine, all of its checks), then the inputs of the
    largest chromosome's own K1, K2, K5 and K4 calls from one more
    TorchEngine run, each kernel held to its plain version there.
    Returns {"ladder": TorchEngine's warm launches, "ladder_sharded":
    the sharded engine's} and each kernel's sums."""
    from genrich_tpu_torch import bench
    t0 = time.perf_counter()
    rung = bench.mem_rung(N_LADDER, bam, reps=1, device=DEV, work=WORK,
                          timeout=1800.0)
    engines = {}
    for eng in bench.ENGINES:
        e = rung[eng]
        engines[eng] = {k: e[k] for k in (
            "cold_s", "rep_s", "ready_s", "cold_stages", "stages",
            "max_memory_allocated_by_card", "rss_mb", "ratio_reps",
            "peak_redispatch", "host_peak_chroms", "launches_by_card",
            "rows", "summits")}
    say("ladder", pairs=N_LADDER, bam_mb=rung["bam_mb"],
        records=rung["records"], peaks=rung["peaks"],
        exact_s=rung["exact_s"], exact_rss_mb=rung["exact_rss_mb"],
        exact_phases=rung["exact_phases"], engines=engines,
        exact_log_written=rung["exact_log_written"], checks=rung["checks"],
        faults=rung["faults"], seconds=time.perf_counter() - t0)
    failed = [k for k, v in rung["checks"].items() if not v]
    if failed:
        raise AssertionError(f"ladder: failed checks {failed}: "
                             f"{rung['faults']}")
    counts = {f"ladder{'' if eng == 'jax' else '_' + eng}":
              rung[eng]["launches_by_card"][-1]["0"]
              for eng in bench.ENGINES}
    return counts, ladder_kernels(bam)


def ladder_kernels(bam, label="ladder"):
    """One more TorchEngine run on ``bam`` keeping the inputs of its K1,
    K2, K5 and K4 calls; the largest chromosome's call of each held to
    its plain version (and its first design), with K2's rows read from
    its tables and beyond them.  Returns each kernel's sums."""
    import torch
    from genrich_tpu_torch.engine import torch_bridge
    from genrich_tpu_torch.ops import peaks, pipeline
    t0 = time.perf_counter()
    calls = kernel_inputs(label, bam, [(pipeline, "coverage_scan"),
                                       (torch_bridge, "tile_stats"),
                                       (peaks, "peak_candidates"),
                                       (peaks, "peak_reduce")])
    big = {name: _largest(calls, name) for name in calls}
    del calls
    k2_args = [a.to(torch.device(DEV)) if torch.is_tensor(a) else a
               for a in big["tile_stats"]]
    tables = _k2_tables(k2_args)
    del k2_args
    say(f"{label}_k2_tables", **tables)
    raised = _raised_past_tables(big["tile_stats"])
    raised_tables = _k2_tables([a.to(torch.device(DEV))
                                if torch.is_tensor(a) else a
                                for a in raised])
    say(f"{label}_raised_k2_tables", **raised_tables)
    if not raised_tables["integral_at_or_above_table"]:
        raise AssertionError(f"{label}: no raised row reaches K2's "
                             f"beyond-table branch")
    k2 = k2_path_phase([big["tile_stats"]], label)
    k2_raised = k2_path_phase([raised], f"{label} raised")
    del raised
    sums = {"coverage_scan": k1_path_phase([big["coverage_scan"]], label),
            "tile_stats": dict(k2, tables=tables, raised=dict(
                k2_raised, tables=raised_tables), max_abs_err=max(
                k2["max_abs_err"], k2_raised["max_abs_err"])),
            "gap_join": k5_path_phase([big["peak_candidates"]], label),
            "peak_reduce": k4_path_phase([big["peak_reduce"]], label)}
    say(f"{label}_kernels", seconds=time.perf_counter() - t0,
        **{name: {k: v[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "max_abs_err")}
           for name, v in sums.items()})
    return sums


ALONE = {"sharded_cards": sharded_cards_phase,
         "sharded_ranks": sharded_ranks_phase, "ladder": ladder_phase}
# the BAMs each run makes (``start_synth``)
NEEDS = {"sharded_cards": ("a", "b", "c"), "sharded_ranks": ("a", "b", "c"),
         "ladder": ("ladder",)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and (len(argv) != 2 or argv[0] != "--phase"
                 or argv[1] not in ALONE):
        raise SystemExit("usage: chip_smoke.py [--phase sharded_cards|"
                         "sharded_ranks|ladder]")
    smi = card()
    start_synth(NEEDS[argv[1]] if argv else BAMS)
    try:
        return run_alone(argv[1]) if argv else run_phases(smi)
    finally:
        stop_synth()


def _blacklist() -> str:
    """Phase 11's blacklist, written now (with the main path's exact file
    it needs) when phase 14 runs alone."""
    path = os.path.join(WORK, "chip_smoke", "blk.bed")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        ref = os.path.join(WORK, "chip_smoke", "main_exact.np")
        if not os.path.exists(ref):
            exact_oracle("main", ["-t", synth_bam("a")] + FLAGS, {"-o": ref})
        path = write_blacklist()[0]
    return path


def run_alone(name) -> int:
    """``--phase sharded_cards``, ``sharded_ranks`` or ``ladder``: the
    build, the BAMs and phase 14, 15 or 16 alone (the one-card
    references phases 14-15 need made on cuda:0); no result line."""
    build()
    bams = [synth_bam(k) for k in NEEDS[name]]
    if name == "ladder":
        ladder_phase(*bams)
    else:
        ALONE[name](*bams, _blacklist())
    say("done", seconds=time.perf_counter() - T0)
    return 0


def run_phases(smi) -> int:
    build()
    bam_a, bam_b, bam_c, bam_log = (synth_bam(k)
                                    for k in ("a", "b", "c", "log"))
    entries = scan_stats_phase() + [fisher_phase()]
    main_counts = main_path(bam_a)
    calls = main_kernel_inputs(bam_a)
    merge_phase(calls["pileup_runs"], "main")
    entries[0].update(k1_path_phase(calls["coverage_scan"], "main"))
    k2 = k2_path_phase(calls["tile_stats"], "main")
    entries[1].update(k2, max_abs_err=max(entries[1]["max_abs_err"],
                                          k2["max_abs_err"]))
    entries.append(peaks_phase(calls["peak_reduce"]))
    entries.append(gap_join_phase(calls["peak_candidates"]))
    del calls
    control_path(bam_a, bam_b)
    calls = control_kernel_inputs(bam_a, bam_b)
    merge_phase(calls["pileup_runs"], "control")
    k2 = k2_path_phase(calls["tile_stats"], "control")
    entries[1]["control_path"] = k2
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"],
                                    k2["max_abs_err"])
    k4 = k4_path_phase(calls["peak_reduce"], "control")
    entries[3]["control_path"] = k4
    entries[3]["max_abs_err"] = max(entries[3]["max_abs_err"],
                                    k4["max_abs_err"])
    entries[4]["control_path"] = k5_path_phase(calls["peak_candidates"],
                                               "control")
    del calls
    fisher_counts = fisher_path(bam_a, bam_b)
    calls = fisher_kernel_inputs(bam_a, bam_b)
    k3 = k3_path_phase(calls["fisher_combine"], "fisher")
    entries[2].update(k3, max_abs_err=max(entries[2]["max_abs_err"],
                                          k3["max_abs_err"]))
    entries[4]["fisher_path"] = k5_path_phase(calls["peak_candidates"],
                                              "fisher")
    del calls
    sharded_counts, sharded = sharded_path(bam_a)
    sharded_fisher_counts, k3, k5 = sharded_fisher_path(bam_a, bam_b)
    sharded["fisher_combine"] = k3
    entries[4]["sharded_fisher_path"] = k5
    for e in entries:
        e["sharded_path"] = sharded[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"],
                               sharded[e["name"]]["max_abs_err"])
    serve_phase(bam_a)
    logs_path(bam_log)
    chip_counts, chip_sums = chip_phases(bam_a, bam_b, bam_c)
    bench_counts, chip_sums["bench"], lam_bench = bench_phase(bam_a)
    chip_counts["bench"] = bench_counts
    chip_counts["sharded_cards"] = sharded_cards_phase(bam_a, bam_b, bam_c,
                                                       _blacklist())
    chip_counts["sharded_ranks"] = sharded_ranks_phase(bam_a, bam_b, bam_c,
                                                       _blacklist())
    ladder_counts, chip_sums["ladder"] = ladder_phase(synth_bam("ladder"))
    chip_counts.update(ladder_counts)
    entries[0]["lambda_mode"]["bench_path"] = lam_bench
    entries[0]["lambda_mode"]["p_max_abs_err"] = max(
        entries[0]["lambda_mode"]["p_max_abs_err"], lam_bench["p_max_abs_err"])
    for path, sums in chip_sums.items():
        for e in entries:
            if e["name"] in sums:
                e[f"{path}_path"] = sums[e["name"]]
                e["max_abs_err"] = max(e["max_abs_err"],
                                       sums[e["name"]]["max_abs_err"])
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"jax", "genrich_tpu"})
    if loaded:
        raise AssertionError(f"{loaded} imported by the smoke's process")
    from genrich_tpu_torch import testing
    mapped = testing.mapped_files(os.path.join(REPO, "native"))
    if mapped:
        raise AssertionError(f"{mapped} mapped into the smoke's process")
    say("native", jax_package_files_mapped=mapped)
    for e in entries:
        path = fisher_counts if e["name"] == "fisher_combine" \
            else main_counts
        e["launches"] = path[e["name"]]
        e["launches_by_path"] = {
            "main": main_counts[e["name"]],
            "fisher": fisher_counts[e["name"]],
            "sharded": sharded_counts[e["name"]],
            "sharded_fisher": sharded_fisher_counts[e["name"]],
            **{path: c[e["name"]] for path, c in chip_counts.items()}}
    import torch
    say("done", seconds=time.perf_counter() - T0)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the device time goes on the port's main and Fisher paths.

    python -m genrich_tpu_torch.prof A.bam B.bam [--engine jax|sharded]
        [--chip BLK.bed C.bam] [--parent DIR [--log-bam L.bam]]

Runs ``-t A`` (main path), ``-t A -c B`` (control) and ``-t A,B``
(Fisher) with ``-r -j -q 0.05 -a 20 --device cuda`` and the
``--engine`` given (default jax: the TorchEngine), each once cold and
once warm under ``torch.profiler``, and prints for the warm run: its
wall, the
pipeline's ``perf`` dict (``findpeaks_s`` split into ``peak_fetch_s``,
the sharded engine's boundary merge ``peak_merge_s`` among it, and
``peak_write_s``, the writer), the device time (kernels and copies,
summed from the profiler's device events), the card's idle share (1 -
device time / wall), the same per card (``device_ms_by_card``,
``idle_share_by_card``: the sharded engine spans every card the
process sees; its runs join no process group) with each card's
launches and its device time in NCCL's kernels and in copies between
cards and on a card (``comm_ms_by_card``), and the top device
entries.
With ``--chip`` also Genrich's ChIP-seq runs of ``chip_smoke.py``:
``chip`` (``-t A -c B``) and ``chip_fisher`` (``-t A,B -c C,C``), each
with ``-r -p 0.01 -a 20 -E BLK.bed -e chr3``.

No device path calls ``torch.cummax`` (PyTorch's
``tensor_kernel_scan_innermost_dim_with_indices``): the gap-join runs
as kernel K5 and the distinct-p table without a scan of maxima, so a
warm run with such a record exits non-zero (``cummax_records``).

torch.profiler has been seen to drop device records on the H100 host,
so a breakdown is printed only when the profiler recorded every hand
kernel that the run launched: each device kernel of
``kernels.KERNELS_PER_CALL`` as many times as ``kernels.LAUNCHES``
counted its wrapper's calls (``record_shortfall``).  A warm run that
fails this check is reported and run again, up to ``ATTEMPTS`` times;
then the profiler exits non-zero, naming the kernel and both counts.

With ``--parent DIR``, another checkout of the repo (say the parent
commit, unpacked with ``git archive``), it then runs in child
processes, parent / this tree / this tree / parent, the main path, the
Fisher path with both engines and, with ``--log-bam``, the ``-f``/``-k``
log run on that BAM, each cold and warm, and prints each run's wall,
peak device memory of each card (``torch.cuda.max_memory_allocated``)
and the md5
of each output file.  Each child's CLI makes native ingest load
through its own tree's ``ingest.ensure_native()``; the child prints the
library it used.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]
CHIP_FLAGS = ["-r", "-p", "0.01", "-a", "20"]     # + -E BLK.bed -e chr3
TOP = 18
ATTEMPTS = 3

# One tree's runs, each cold then warm, in a fresh process: argv is
# tree, output directory, then a JSON list of (name, arguments, output
# flags); prints one JSON line per run.
_CHILD = """
import hashlib, json, os, sys, time
tree, out_dir, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, tree)
import torch
from genrich_tpu_torch import cli
from genrich_tpu_torch.ingest import ensure_native
cards = range(torch.cuda.device_count())
for name, args, flags in runs:
    res = {}
    for label in ("cold", "warm"):
        outs = {f: os.path.join(out_dir, name + "_" + label + f)
                for f in flags}
        for i in cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        rc = cli.main(args + [x for f in flags for x in (f, outs[f])]
                      + ["--device", "cuda"])
        for i in cards:
            torch.cuda.synchronize(i)
        res[label] = {
            "rc": rc, "wall_s": time.perf_counter() - t0,
            "max_memory_allocated_by_card": [
                torch.cuda.max_memory_allocated(i) for i in cards],
            "md5": {f: hashlib.md5(open(o, "rb").read()).hexdigest()
                    for f, o in outs.items()},
            "native_ingest": ensure_native()["path"]}
    print(name + " " + json.dumps(res), flush=True)
"""


def _on_device(e) -> bool:
    """Whether a profiler event is device work: a CUDA record that is
    not the device-side copy of a ``record_function`` range (the port's
    ``pipeline.*`` spans), whose time its kernels already hold."""
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(e, "is_user_annotation", False)


def _device_events(prof):
    evs = []
    for e in prof.key_averages():
        if not _on_device(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        evs.append((us / 1e3, e.count, e.key))
    return sorted(evs, reverse=True)


def _device_ms_by_card(prof):
    """Device milliseconds of one profiled run on each card index."""
    per = {}
    for e in prof.events():
        if not _on_device(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per[e.device_index] = per.get(e.device_index, 0.0) + us / 1e3
    return dict(sorted(per.items()))


def comm_ms_by_card(prof):
    """Device milliseconds of one profiled run on each card index in
    NCCL's kernels (``nccl``), in copies between two cards (``ptop``:
    the collectives' peer copies) and in copies on one card (``dtod``)."""
    per = {}
    for e in prof.events():
        if not _on_device(e):
            continue
        kind = "nccl" if "nccl" in e.name.lower() else "ptop" \
            if "PtoP" in e.name else "dtod" if "DtoD" in e.name else None
        if kind is None:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        card = per.setdefault(e.device_index, dict.fromkeys(
            ("nccl", "ptop", "dtod"), 0.0))
        card[kind] += us / 1e3
    return dict(sorted(per.items()))


def record_shortfall(records, launches):
    """Hand kernels whose device records disagree with their launches.

    ``records``: (kernel name as the profiler gives it, record count)
    pairs of one profiled run; ``launches``: ``kernels.LAUNCHES`` of
    that run.  Returns (kernel, records, expected) for every device
    kernel of ``kernels.KERNELS_PER_CALL`` whose records differ from
    the calls of its wrapper times its share of each call; empty when
    the profiler saw every launch."""
    from .kernels import KERNELS_PER_CALL, is_kernel
    bad = []
    for wrapper, per_call in KERNELS_PER_CALL.items():
        for ident in dict.fromkeys(per_call):
            want = launches.get(wrapper, 0) * per_call.count(ident)
            got = sum(n for key, n in records if is_kernel(key, ident))
            if got != want:
                bad.append((ident, got, want))
    return bad


CUMMAX_KERNEL = "scan_innermost_dim_with_indices"


def cummax_records(records):
    """Device records of PyTorch's cummax/cummin scan kernel among
    (kernel name, record count) pairs."""
    return sum(n for key, n in records if CUMMAX_KERNEL in key)


def profile_path(name, ts, engine="jax", extra=(), flags=FLAGS):
    """Cold run, then the warm run under torch.profiler, again while the
    profiler's hand-kernel records disagree with the launches (at most
    ATTEMPTS runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import cli, kernels
    from .engine.perf import synchronize_cards
    out = os.path.join(tempfile.mkdtemp(), "out.np")
    args = ["-t", ts, "-o", out, *extra] + flags + [
        "--engine", engine, "--device", "cuda"]
    if cli.main(args) != 0:
        raise SystemExit(f"{name}: cold run failed")
    for attempt in range(1, ATTEMPTS + 1):
        synchronize_cards()
        kernels.reset_launches()
        perf = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rc = cli.main(args, perf=perf)
            synchronize_cards()
            wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"{name}: warm run failed")
        evs = _device_events(prof)
        short = record_shortfall([(key, n) for _, n, key in evs],
                                 kernels.LAUNCHES)
        if not short:
            break
        print(f"profile {name} attempt {attempt}: profiler records "
              f"disagree with the launches: " + "; ".join(
                  f"{k}: {got} device records, {want} launched "
                  f"(kernels.LAUNCHES)" for k, got, want in short))
    else:
        raise SystemExit(f"{name}: torch.profiler's hand-kernel records "
                         f"disagreed with the launches in all {ATTEMPTS} "
                         f"warm runs; no breakdown")
    device_ms = sum(ms for ms, _, _ in evs)
    by_card = _device_ms_by_card(prof)
    scans = cummax_records([(key, n) for _, n, key in evs])
    print(f"profile {name} " + json.dumps(
        {"engine": engine, "wall_s": wall, "device_ms": device_ms,
         "idle_share": 1.0 - device_ms / 1e3 / wall,
         "device_ms_by_card": by_card,
         "idle_share_by_card": {i: 1.0 - ms / 1e3 / wall
                                for i, ms in by_card.items()},
         "comm_ms_by_card": comm_ms_by_card(prof),
         "card_launches": kernels.CARD_LAUNCHES, "attempt": attempt,
         "cummax_records": scans, "launches": dict(kernels.LAUNCHES),
         "perf": perf}))
    for ms, n, key in evs[:TOP]:
        print(f"  {ms:10.3f} ms {100 * ms / device_ms:5.1f}% x{n:<5d} "
              f"{key[:90]}")
    if scans:
        raise SystemExit(f"{name}: {scans} torch.cummax device records")


def compare_trees(parent, bam_a, bam_b, log_bam=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fisher = ["-t", f"{bam_a},{bam_b}"] + FLAGS
    runs = [("main", ["-t", bam_a] + FLAGS, ["-o"]),
            ("fisher", fisher, ["-o"]),
            ("sharded_fisher", fisher + ["--engine", "sharded"], ["-o"])]
    if log_bam:
        runs.append(("logs", ["-t", log_bam] + FLAGS, ["-o", "-f", "-k"]))
    for label, tree in (("parent", parent), ("this", here),
                        ("this", here), ("parent", parent)):
        out_dir = tempfile.mkdtemp()
        r = subprocess.run([sys.executable, "-c", _CHILD,
                            os.path.abspath(tree), out_dir,
                            json.dumps(runs)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise SystemExit(f"{label} tree failed: {r.stderr[-2000:]}")
        for line in r.stdout.strip().splitlines():
            print(f"tree {label} {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m genrich_tpu_torch.prof")
    ap.add_argument("bam_a")
    ap.add_argument("bam_b")
    ap.add_argument("--engine", choices=("jax", "sharded"), default="jax")
    ap.add_argument("--chip", nargs=2, metavar=("BLK_BED", "C_BAM"),
                    help="also the ChIP runs: the -E blacklist and the "
                    "ChIP Fisher replicates' control")
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--log-bam", help="with --parent: the BAM of the "
                    "-f/-k log run")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof: no CUDA card")
    from .ingest import ensure_native
    nat = ensure_native()
    print("native " + json.dumps(nat, default=str))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card {smi}")
    profile_path("main", a.bam_a, a.engine)
    profile_path("control", a.bam_a, a.engine, ["-c", a.bam_b])
    profile_path("fisher", f"{a.bam_a},{a.bam_b}", a.engine)
    if a.chip:
        bed, bam_c = a.chip
        chip = CHIP_FLAGS + ["-E", bed, "-e", "chr3"]
        profile_path("chip", a.bam_a, a.engine, ["-c", a.bam_b], chip)
        profile_path("chip_fisher", f"{a.bam_a},{a.bam_b}", a.engine,
                     ["-c", f"{bam_c},{bam_c}"], chip)
    if a.parent:
        compare_trees(a.parent, a.bam_a, a.bam_b, a.log_bam)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the device time goes on the port's main and Fisher paths.

    python -m genrich_tpu_torch.prof A.bam B.bam [--parent DIR]

Runs ``-t A`` (main path) and ``-t A,B`` (Fisher) with ``-r -j -q 0.05
-a 20 --device cuda``, each once cold and once warm under
``torch.profiler``, and prints for the warm run: its wall, the
pipeline's ``perf`` dict, the device time (kernels and copies, summed
from the profiler's device events), the card's idle share (1 - device
time / wall) and the top device entries.

With ``--parent DIR``, another checkout of the repo (say the parent
commit, unpacked with ``git archive``), it then runs the main path in
child processes, parent / this tree / this tree / parent, each cold and
warm, and prints each run's wall, peak device memory
(``torch.cuda.max_memory_allocated``) and the md5 of its narrowPeak.
Every child reads BAMs through the native ingest library that this
tree's ``ingest.ensure_native()`` makes load.
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
TOP = 18

# One tree's main path, cold then warm, in a fresh process: argv is
# tree, native library, BAM, output directory; prints one JSON line.
_CHILD = """
import hashlib, json, os, sys, time
tree, so, bam, out_dir = sys.argv[1:5]
sys.path.insert(0, tree)
from genrich_tpu.ingest import native
native._SO = so
import torch
from genrich_tpu_torch import cli
res = {}
for label in ("cold", "warm"):
    out = os.path.join(out_dir, label + ".np")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["-t", bam, "-o", out] + sys.argv[5:]
                  + ["--device", "cuda"])
    torch.cuda.synchronize()
    res[label] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "md5": hashlib.md5(open(out, "rb").read()).hexdigest(),
                  "native_ingest": native.available(build=False)}
print(json.dumps(res))
"""


def _device_events(prof):
    import torch
    evs = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        evs.append((us / 1e3, e.count, e.key))
    return sorted(evs, reverse=True)


def profile_path(name, ts):
    """Cold run, then the warm run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import cli
    out = os.path.join(tempfile.mkdtemp(), "out.np")
    args = ["-t", ts, "-o", out] + FLAGS + ["--device", "cuda"]
    if cli.main(args) != 0:
        raise SystemExit(f"{name}: cold run failed")
    torch.cuda.synchronize()
    perf = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(args, perf=perf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"{name}: warm run failed")
    evs = _device_events(prof)
    device_ms = sum(ms for ms, _, _ in evs)
    print(f"profile {name} " + json.dumps(
        {"wall_s": wall, "device_ms": device_ms,
         "idle_share": 1.0 - device_ms / 1e3 / wall, "perf": perf}))
    for ms, n, key in evs[:TOP]:
        print(f"  {ms:10.3f} ms {100 * ms / device_ms:5.1f}% x{n:<5d} "
              f"{key[:90]}")


def compare_trees(parent, bam, so):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for label, tree in (("parent", parent), ("this", here),
                        ("this", here), ("parent", parent)):
        out_dir = tempfile.mkdtemp()
        r = subprocess.run([sys.executable, "-c", _CHILD,
                            os.path.abspath(tree), so, bam, out_dir]
                           + FLAGS, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{label} tree failed: {r.stderr[-2000:]}")
        print(f"tree {label} " + r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m genrich_tpu_torch.prof")
    ap.add_argument("bam_a")
    ap.add_argument("bam_b")
    ap.add_argument("--parent", help="another checkout to compare with")
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
    profile_path("main", a.bam_a)
    profile_path("fisher", f"{a.bam_a},{a.bam_b}")
    if a.parent:
        compare_trees(a.parent, a.bam_a, nat["path"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

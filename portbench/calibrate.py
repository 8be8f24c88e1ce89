"""The readings that the limits of a cell's check are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--control 3]

For each seed, in one process: the cell's pool of samples, each
analysed twice by the port on the card, every distinct
output compared with the reference (the run's numbers, as a run
compares them); for the first ``--control`` seeds also the control,
the reference computed in bfloat16 and put in the program's place.
One JSON line a seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    a = ap.parse_args(argv)
    import torch

    from . import harness
    _, _, config, traffic = harness.load_cell(a.workload)
    tmpdir = tempfile.mkdtemp(prefix="portbench_")      # under TMPDIR
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        c = harness.Cell(harness.with_depth(config, traffic.get("depth", 1)),
                         traffic, seed, "cuda", tmpdir)
        eng = c.engine()
        walls = []
        for _ in range(2):
            for i in range(len(c.pool)):
                walls.append(c.analysis(eng, i, harness.Spans(False))
                             ["seconds"])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        worst, info = c.check()
        line = {"seed": seed, "program": worst, "outputs": info["outputs"],
                "peaks": info["peaks"], "scalars": info["scalars"],
                "walls": walls}
        if k < a.control:
            ctl = {}
            for i in range(len(c.pool)):
                for key, v in c.control(i, torch.bfloat16).items():
                    ctl[key] = max(ctl.get(key, 0.0), v)
            line["control"] = ctl
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del c
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of genrich_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics and ``breakdown`` with ``--trace 1``), ``device`` and
last ``checks``, each number compared with its limit (also the last
lines of standard error).  Exits non-zero, printing no result, without
a CUDA card (or fewer than the cell asks for), and when the process
holds a module of JAX or of the JAX package once the window has
closed.  Every metric is read by ``metrics/<name>.py``, every hand
kernel's work by ``kernels/<kernel>.py``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genrich_tpu")


def forbidden_modules():
    """Modules of JAX or the JAX package this process holds, by their
    whole top-level name."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def metric_entries(bench, cell, trace):
    """The cell's metrics for this kind of run: end-to-end with trace
    0, per-layer with trace 1 (those whose ``workloads`` name the cell,
    or that name none)."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def judge(run):
    """Whether a run is correct, and {number: {"value", "limit"}}: every
    analysis completed, every pool sample's outputs were compared with
    a reference that calls peaks, and every number is within its
    limit."""
    limits = run["config"]["limits"]
    out = {k: {"value": run["worst"].get(k), "limit": limits[k]}
           for k in limits}
    info = run["info"]
    correct = (all(v["value"] is not None and v["value"] <= v["limit"]
                   for v in out.values())
               and run["failed"] == 0 and bool(run["recs"])
               and info["outputs"] > 0 and min(info["peaks"]) > 0)
    return correct, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    from . import harness
    bench, cell, _, _ = harness.load_cell(a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    run = harness.run(a.workload, a.seed, a.seconds, a.trace, "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    metrics = {}
    for m in metric_entries(bench, cell, a.trace):
        mod = harness.load_module(harness.ROOT / "metrics" / f"{m['name']}.py")
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, chk = judge(run)
    for err in run["errors"][:3]:
        print(err, file=sys.stderr)
    info = run["info"]
    print(f"portbench: {len(run['recs'])} analyses, {info['outputs']} "
          f"outputs checked, reference peaks {info['peaks']}, "
          f"lambda/factor {info['scalars']}; set-up {run['setup_s']:.3f} s,"
          f" window {run['window_s']:.3f} s, trace reading "
          f"{info['reduce_s']:.3f} s, check {info['check_s']:.3f} s; "
          f"analyses (s) {[round(r['seconds'], 3) for r in run['recs']]}",
          file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": run["peak"]}
    res = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": device}
    tr = run["trace"]
    if a.trace and tr:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        res["breakdown"] = tr["breakdown"]
    res["checks"] = chk
    for k, v in chk.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of a benchmark cell: set-up, the measured window, the check.

A cell names a configuration (``configs/<config>.json``: genome, flags,
-E regions, the sample's files and shape, the limits of the check) and
a traffic mix (``traffic/<mix>.json``: ``pool``, the number of samples
made in set-up; ``order``, how the window takes them, "cycle" (the
default: each in turn) or "seeded" (drawn from the seed); ``depth``,
the share of each file's read pairs that a sample holds, 1 by
default).  Set-up writes the run's -E regions to a BED file
in a fresh directory under ``TMPDIR`` (removed at the end), parses the
flags with the port's own parser, makes the pool of samples from the
seed and runs one analysis of each pool sample (every shape the window
uses; the first run in a checkout also builds the port's kernels).
The window then runs analyses back to back, each on the next pool
sample, for ``seconds``; every analysis started before the time is up
completes and counts.

An analysis is the port's device path after ingest: a
``ChromRegistry`` of the genome, an ``EventSink`` per input file filled
with the sample's events, ``pipeline._replicate_device`` per replicate
and ``pipeline._find_peaks_device`` on one ``TorchEngine``, which
writes the narrowPeak rows to a file in that directory.  Its time runs
from the hand-over of the events to the file's close.

After the window, with the program's state freed, the reference
(``reference/``) analyses each pool sample on the same device, and
every distinct output the window produced is compared with it
(``reference/compare.py``).
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_module(path: Path):
    """A benchmark file (a metric reader or a kernel's work) by path:
    their names may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str):
    """(BENCHMARK.json, its cell, the cell's configuration, traffic)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((REPO / entry["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, config, traffic


def with_depth(config, depth):
    """``config`` with every file's read pairs times ``depth``."""
    if depth == 1:
        return config
    config = json.loads(json.dumps(config))
    for f in config["sample"]["files"]:
        f["pairs"] = round(f["pairs"] * depth)
    return config


def schedule(traffic, seed, n):
    """The pool samples that the window's analyses take, in order."""
    order = traffic.get("order", "cycle")
    if order == "cycle":
        i = 0
        while True:
            yield i % n
            i += 1
    elif order == "seeded":
        import numpy as np

        from .generate import sub_seed
        rng = np.random.default_rng(sub_seed(seed, "order"))
        while True:
            yield int(rng.integers(n))
    else:
        raise ValueError(f"unknown traffic order {order!r}")


def thresholds(flags: str):
    """The peak caller's settings as Genrich reads its flags (its
    documented defaults otherwise), for the reference."""
    f = flags.split()

    def arg(opt, default):
        return f[f.index(opt) + 1] if opt in f else default
    use_q = "-q" in f
    return {"qval": use_q,
            "pq": float(arg("-q", "0.05") if use_q else arg("-p", "0.01")),
            "min_auc": float(arg("-a", "200")),
            "min_len": int(arg("-l", "0")), "max_gap": int(arg("-g", "100"))}


class Spans:
    """Host-clock spans of the harness around each layer's call, summed
    per analysis; under the profiler each is also a ``record_function``
    so that the trace can name what the host was doing."""

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.current = None

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        rf = torch.profiler.record_function(name) if self.profiled \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            if self.current is not None:
                self.current[name] = self.current.get(name, 0.0) \
                    + time.perf_counter() - t0


class Cell:
    """The port driven on one cell's pool of samples."""

    def __init__(self, config, traffic, seed, device, tmpdir):
        import torch

        from genrich_tpu_torch import params
        from genrich_tpu_torch.io.bed import load_bed

        from . import generate
        self.config = config
        self.device = torch.device(device)
        self.regions = generate.exclusions(config, seed)
        bed = os.path.join(tmpdir, "portbench_exclude.bed")
        with open(bed, "w") as f:
            for name, regs in self.regions.items():
                for s, e in regs:
                    f.write(f"{name}\t{s}\t{e}\n")
        out = os.path.join(tmpdir, "portbench_peaks.narrowPeak")
        spec = config["sample"]
        reps = sorted({f["replicate"] for f in spec["files"]})
        self.names = [[f["name"] for f in spec["files"]
                       if f["replicate"] == r and f["role"] == role]
                      for role in ("treatment", "control") for r in reps]
        treat = ",".join(n[0] for n in self.names[:len(reps)])
        argv = config["flags"].format(exclude=bed).split() + [
            "-t", treat, "-o", out]
        ctrl = [n[0] if n else "null" for n in self.names[len(reps):]]
        if any(n != "null" for n in ctrl):
            argv += ["-c", ",".join(ctrl)]
        self.params = params.parse_args(argv)
        self.xbed = load_bed(self.params.x_file) if self.params.x_file \
            else []
        self.pool = []
        for i in range(traffic["pool"]):
            self.pool.append(generate.sample(config, seed, i, self.device))
        self.outputs = [dict() for _ in self.pool]

    def engine(self):
        from genrich_tpu_torch.engine.torch_bridge import TorchEngine
        return TorchEngine(self.device)

    def analysis(self, eng, index, spans):
        """One analysis of pool sample ``index``; returns its record."""
        from genrich_tpu_torch import pipeline
        from genrich_tpu_torch.ingest.chroms import ChromRegistry
        from genrich_tpu_torch.ingest.intervals import EventSink
        from genrich_tpu_torch.io import files
        reps, pairs = self.pool[index]
        p = self.params
        genome = self.config["genome"]
        spans.current = rec = {}
        t0 = time.perf_counter()
        with spans("portbench.analysis"):
            with spans("portbench.handover"):
                registry = ChromRegistry(p.xchr_list, self.xbed, p.verbose)
                for name, n in genome:
                    registry.save_chrom(name, n, False)
                sinks = []
                for treat, ctrl in reps:
                    pair = []
                    for ev in (treat, ctrl):
                        if ev is None:
                            pair.append(None)
                            continue
                        sink = EventSink()
                        for name, arrays in ev.items():
                            c = registry.by_name[name]
                            if not c.skip and len(arrays[0]):
                                sink.by_chrom[c.index] = list(arrays)
                        pair.append(sink)
                    sinks.append(pair)
            eng.begin_run()
            pvals = {}
            for si, (es, cs) in enumerate(sinks):
                registry.reset_save_flags()
                for name, n in genome:
                    registry.save_chrom(name, n, False)
                with spans("pipeline._replicate_device"):
                    pipeline._replicate_device(
                        eng, registry, es, cs, p, si, pvals, None,
                        self.names[si][0],
                        self.names[len(sinks) + si][0]
                        if self.names[len(sinks) + si] else None,
                        True, archive=len(sinks) > 1)
            out = files.open_write(p.out_file, p.gz_out)
            with spans("pipeline._find_peaks_device"):
                pipeline._find_peaks_device(registry, eng, p, out)
            out.close()
        seconds = time.perf_counter() - t0
        with spans("portbench.output"):
            data = Path(p.out_file).read_bytes()
            digest = hashlib.blake2b(data, digest_size=16).hexdigest()
            self.outputs[index].setdefault(digest, data)
        spans.current = None
        return {"sample": index, "seconds": seconds, "pairs": pairs,
                "spans": rec, "perf": dict(eng.perf), "output": digest}

    def reference(self, index, prec=None):
        """The reference's peaks of pool sample ``index`` on this
        device: {chrom name: {column: numpy array}}."""
        import torch

        from .reference import analysis
        from .reference.analysis import merge_bed, threshold
        from .generate import skipped
        th = thresholds(self.config["flags"])
        skip = skipped(self.config)
        setup = {"chroms": [(name, n, merge_bed(self.regions.get(name, []),
                                                n))
                            for name, n in self.config["genome"]
                            if name not in skip],
                 "thr": threshold(th["pq"]), "qval": th["qval"],
                 "min_auc": float(th["min_auc"]),
                 "min_len": th["min_len"], "max_gap": th["max_gap"]}
        reps, _ = self.pool[index]
        with torch.no_grad():
            res, scalars = analysis.analyse(
                setup, reps, self.device,
                torch.float32 if prec is None else prec)
        peaks = {name: {k: v.cpu().numpy() for k, v in pk.items()}
                 for name, pk in res.items()}
        return peaks, scalars

    def control(self, index, prec):
        """The control's numbers on pool sample ``index``: the reference
        computed in ``prec``, put in the program's place and compared
        with the reference."""
        from .reference.compare import compare, parse, to_text
        use_q = thresholds(self.config["flags"])["qval"]
        want, _ = self.reference(index)
        low, _ = self.reference(index, prec)
        text = to_text(low, [n for n, _ in self.config["genome"]])
        return compare(parse(text), want, use_q)[0]

    def check(self):
        """Every distinct output against the reference: the worst of
        each number, the peak count and the reference's lambdas."""
        from .reference.compare import compare, parse
        use_q = thresholds(self.config["flags"])["qval"]
        worst, info = {}, {"outputs": 0, "peaks": [], "scalars": []}
        for i, outs in enumerate(self.outputs):
            if not outs:
                continue
            want, scalars = self.reference(i)
            info["scalars"].append(scalars)
            for data in outs.values():
                nums, n_ref, _ = compare(parse(data.decode()), want, use_q)
                info["outputs"] += 1
                info["peaks"].append(n_ref)
                for k, v in nums.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst, info


def run(workload, seed, seconds, trace, device="cuda", t0=None,
        tmpdir=None):
    """One run of ``workload`` (see ``run_cell``)."""
    _, cell, config, traffic = load_cell(workload)
    return run_cell(cell, config, traffic, seed, seconds, trace, device,
                    t0, tmpdir)


def run_cell(cell, config, traffic, seed, seconds, trace, device="cuda",
             t0=None, tmpdir=None):
    """One run of a cell: what the result line and its readers need."""
    t0 = time.perf_counter() if t0 is None else t0
    own = tmpdir is None
    if own:                # a fresh directory under TMPDIR, removed after
        tmpdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        return _run_cell(cell, config, traffic, seed, seconds, trace,
                         device, t0, tmpdir)
    finally:
        if own:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _run_cell(cell, config, traffic, seed, seconds, trace, device, t0,
              tmpdir):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    c = Cell(with_depth(config, traffic.get("depth", 1)), traffic, seed,
             dev, tmpdir)
    order = schedule(traffic, seed, len(c.pool))
    eng = c.engine()
    spans = Spans(profiled=bool(trace))
    # warm-up: every pool sample once (kernel build, every shape)
    for i in range(len(c.pool)):
        c.analysis(eng, i, Spans(False))
    for o in c.outputs:
        o.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kern = [load_module(p) for p in sorted((ROOT / "kernels").glob("*.py"))]
    calls = {k.NAME: [] for k in kern}
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from . import trace as trace_mod
            for k in kern:
                stack.enter_context(trace_mod.recording(k, calls[k.NAME]))
            prof = stack.enter_context(trace_mod.profiler())
        setup_s = time.perf_counter() - t0
        recs, failed, errors = [], 0, []
        start = time.perf_counter()
        i = 0
        with spans("portbench.window"):
            while time.perf_counter() - start < seconds:
                try:
                    recs.append(c.analysis(eng, next(order), spans))
                except Exception:          # counted, reported, judged
                    failed += 1
                    errors.append(traceback.format_exc())
                i += 1
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    tr = None
    if trace:
        from . import trace as trace_mod
        tr = trace_mod.reduce(prof, kern, calls, len(recs))
    del eng, prof, calls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    worst, info = c.check()
    info["check_s"] = time.perf_counter() - t_check
    info["reduce_s"] = t_check - start - window_s
    return {"cell": cell, "config": config, "recs": recs, "failed": failed,
            "attempted": i, "errors": errors, "setup_s": setup_s,
            "window_s": window_s, "peak": peak, "trace": tr,
            "worst": worst, "info": info, "cell_obj": c}

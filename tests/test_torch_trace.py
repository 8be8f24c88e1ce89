"""The device path's spans (``engine/perf.span``) on the CPU.

A small analysis of the benchmark's ATAC configuration (``-r -j -q
0.05``, three short chromosomes) runs through
``pipeline._replicate_device`` and ``pipeline._find_peaks_device`` on
``TorchEngine("cpu")`` and on ``ShardedTorchEngine("cpu", n_shards=8)``,
as ``portbench/harness.py`` runs them.  Checked: every new ``perf`` key
is filled and the disjoint leaf spans sum to no more than the two
calls; under ``torch.profiler`` the program's ``record_function``
ranges carry only the documented names, each inside one of the two
calls, and ``portbench.trace.reduce`` names idle gaps by them rather
than by the harness's span; with the profiler off no
``record_function`` is entered; ``GENRICH_TPU_PROFILE=1`` still prints
the lines ``bench.PHASE_RES`` parses; the six readers of the new
per-layer metrics.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import conftest  # noqa: F401
import oracle

from genrich_tpu_torch import pipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from portbench import harness, trace

SEED = 2 ** 31 + 5
CALLS = ("pipeline._replicate_device", "pipeline._find_peaks_device")
# the leaves that pipeline.unspanned_s subtracts, by perf key
LEAVES = ("cast_s", "upload_s", "dispatch_s", "fetch_s", "qvalue_merge_s",
          "peak_write_s")
NEW_KEYS = ("cast_s", "dispatch_s", "fetch_wait_s", "qvalue_merge_s",
            "peak_write_s")
FIXED = {"pipeline.cast", "pipeline.upload", "pipeline.fetch.wait",
         "pipeline.fetch.copy", "pipeline.qvalue_merge",
         "pipeline.peaks_fetch", "pipeline.peaks_write",
         "pipeline.peak_merge"}
PROGRAMS = {
    "jax": {"tile_coverage", "pileup_runs", "tile_stats", "rle_pv",
            "rle_runs", "distinct_pvals", "merge_fisher", "chrom_peaks"},
    "sharded": {"expand_flat", "cov", "runs", "stats", "distinct", "peaks",
                "rle", "rle_pv", "run_edges", "fisher", "chrom_peaks"},
}
# the summed leaves besides the dispatches: no other summed span holds
# their time (peaks_fetch and peak_merge hold fetches)
DISJOINT = {"pipeline.cast", "pipeline.upload", "pipeline.fetch.wait",
            "pipeline.fetch.copy", "pipeline.qvalue_merge",
            "pipeline.peaks_write"}


def _disjoint(name):
    return name in DISJOINT or name.startswith("pipeline.dispatch.")


def _names(engine):
    return FIXED | {"pipeline.dispatch." + p for p in PROGRAMS[engine]}


def _tiny():
    """The benchmark's ATAC configuration on three chromosomes of about
    250 kbp at a thousandth of its depth, with strong sites."""
    with open(os.path.join(oracle.REPO, "portbench", "configs",
                           "atac_published.json")) as f:
        cfg = json.load(f)
    cfg["genome"] = [[n, max(ln // 1000, 20000)]
                     for n, ln in cfg["genome"]][:3]
    for f in cfg["sample"]["files"]:
        f["pairs"] = f["pairs"] // 1000
    cfg["sample"]["sites"].update(count=10, frip=0.6)
    cfg["exclusions"].update(blacklist_regions=6, blacklist_bp=2000)
    return cfg


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return harness.Cell(_tiny(), {"pool": 1}, SEED, "cpu",
                        str(tmp_path_factory.mktemp("cell")))


def _engine(kind):
    return TorchEngine("cpu") if kind == "jax" \
        else ShardedTorchEngine("cpu", n_shards=8)


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.HARNESS)]


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_perf_keys_filled_and_leaves_within_calls(cell, kind):
    rec = cell.analysis(_engine(kind), 0, harness.Spans(False))
    perf, spans = rec["perf"], rec["spans"]
    for key in NEW_KEYS:
        assert perf[key] >= 0.0, key
    assert perf["cast_s"] > 0 and perf["dispatch_s"] > 0
    assert perf["qvalue_merge_s"] > 0 and perf["peak_write_s"] > 0
    assert perf["fetch_wait_s"] <= perf["fetch_s"]
    assert sum(perf[k] for k in LEAVES) <= sum(spans[k] for k in CALLS)
    if kind == "sharded":
        assert 0 < perf["peak_merge_s"] <= perf["peak_fetch_s"]


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_profiler_names_program_spans(cell, kind):
    eng = _engine(kind)
    cell.analysis(eng, 0, harness.Spans(False))       # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            rec = cell.analysis(eng, 0, harness.Spans(True))
    events = _events(prof)
    calls = [(s, t) for n, s, t in events if n in CALLS]
    ours = [(n, s, t) for n, s, t in events
            if not n.startswith("portbench.") and n not in CALLS]
    names = {n for n, _, _ in ours}
    assert names <= _names(kind), names - _names(kind)
    assert {"pipeline.cast", "pipeline.upload", "pipeline.fetch.wait",
            "pipeline.fetch.copy", "pipeline.qvalue_merge",
            "pipeline.peaks_write"} <= names
    if kind == "sharded":
        assert "pipeline.peak_merge" in names
    for n, s, t in ours:
        assert any(a <= s and t <= b for a, b in calls), n
    if kind == "jax":
        # fifteen spans a chromosome, eleven an analysis
        assert len(ours) <= 15 * len(cell.config["genome"]) + 11, len(ours)
    # idle gaps exactly where the disjoint leaves ran: each is named by
    # its leaf, never by the harness's call around it
    (w0, w1), = [(s, t) for n, s, t in events if n == "portbench.window"]
    leaves = sorted((s, t) for n, s, t in ours if _disjoint(n))
    edges = [w0] + [x for iv in leaves for x in iv] + [w1]
    busy = [_Device(a, b) for a, b in zip(edges[::2], edges[1::2])
            if b > a]
    fake = _Prof(prof.profiler.kineto_results.events() + busy)
    tr = trace.reduce(fake, [], {}, 1)
    idle = dict(tr["breakdown"]["idle_gaps"])
    assert idle and all(_disjoint(n) for n in idle), idle
    assert rec["perf"]["upload_n"] > 0


class _Device:
    """A device record of the shape ``portbench.trace`` reads."""

    def __init__(self, start, end):
        self._s, self._e = start, end

    def activity_type(self):
        return "kernel"

    def name(self):
        return "busy"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


class _Prof:
    def __init__(self, events):
        class _R:
            def events(self_inner):
                return events

        class _P:
            kineto_results = _R()
        self.profiler = _P()


def test_no_record_function_without_profiler(cell, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = TorchEngine("cpu")
    cell.analysis(eng, 0, harness.Spans(False))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        cell.analysis(eng, 0, harness.Spans(False))
    assert entered and all(n.startswith("pipeline.") for n in entered)


def test_profile_lines_and_perf_keys(tmp_path, monkeypatch, capsys):
    from genrich_tpu_torch import bench, params
    oracle.random_sam(str(tmp_path / "in.sam"), seed=11)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "_PROFILE", True)
    args = ["-t", "in.sam", "-y", "-p", "0.01", "-a", "20"]
    pipeline.run(params.parse_args(args + ["-o", "exact.np"]))
    err = capsys.readouterr().err
    for key in ("pileup_s", "pvalues_s", "findpeaks_s"):
        assert bench.PHASE_RES[key].search(err), (key, err)
    perf = {}
    pipeline.run(params.parse_args(args + ["-o", "jax.np"]),
                 engine=TorchEngine("cpu"), perf=perf)
    err = capsys.readouterr().err
    assert bench.PHASE_RES["findpeaks_s"].search(err), err
    assert "[profile] device pileup+p-values: " in err
    for key in NEW_KEYS + ("ingest_s", "device_rep_s", "findpeaks_s",
                           "fetch_s", "upload_s"):
        assert perf[key] >= 0.0, key


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


def _rec(spans, **perf):
    return {"spans": spans, "perf": perf}


def test_readers():
    full = dict(cast_s=0.1, upload_s=0.2, dispatch_s=0.05, fetch_s=0.15,
                fetch_wait_s=0.01, qvalue_merge_s=0.04, peak_write_s=0.12)
    calls = {"pipeline._replicate_device": 0.7,
             "pipeline._find_peaks_device": 0.3}
    run = {"recs": [_rec(calls, **full),
                    _rec(calls, **{k: 2 * v for k, v in full.items()})]}
    want = {"engine.cast_s": 0.15, "engine.dispatch_s": 0.075,
            "engine.fetch_wait_s": 0.015, "engine.qvalue_merge_s": 0.06,
            "pipeline.peak_write_s": 0.18,
            # 1.0 - 0.66 and 1.0 - 1.32, averaged
            "pipeline.unspanned_s": 0.01}
    for name, v in want.items():
        assert _reader(name).read(run) == pytest.approx(v), name
    # a run of a program without the keys (or the harness's spans)
    bare = {"recs": [_rec(calls, upload_s=0.2, fetch_s=0.1)]}
    for name in want:
        if name != "engine.dispatch_s":
            assert _reader(name).read(bare) is None, name
    assert _reader("engine.dispatch_s").read(bare) is None
    nospan = {"recs": [_rec({}, **full)]}
    assert _reader("pipeline.unspanned_s").read(nospan) is None
    assert _reader("engine.cast_s").read({"recs": []}) is None



def _host_route_output(tmp_path, handover):
    """One analysis with a control on ``TorchEngine("cpu")`` of a
    3 Gbp chromosome (the exact engine's host route) beside a short
    one, the sinks holding ``handover`` of native ingest's int64 starts
    and ends and int32 codes.  Returns the narrowPeak bytes."""
    import numpy as np

    from genrich_tpu_torch import params
    from genrich_tpu_torch.ingest.chroms import ChromRegistry
    from genrich_tpu_torch.ingest.intervals import EventSink
    from genrich_tpu_torch.io import files
    genome = (("chrBig", 3_000_000_000), ("chr2", 60_000))
    rng = np.random.default_rng(17)
    out = tmp_path / "out.np"
    p = params.parse_args(["-t", "t", "-c", "c", "-o", str(out), "-y",
                           "-p", "0.5", "-a", "0"])
    reg = ChromRegistry(p.xchr_list, [], p.verbose)
    for name, n in genome:
        reg.save_chrom(name, n, False)
    sinks = []
    for n_ev in (4000, 1500):
        sink = EventSink()
        for name, n in genome:
            lo = 2 ** 31 if n > 2 ** 31 else 0
            centre = rng.integers(lo, lo + 50_000, 20).repeat(n_ev // 20)
            starts = np.sort(centre + rng.integers(0, 400, n_ev))
            ev = (starts.astype(np.int64),
                  starts + rng.integers(50, 300, n_ev),
                  rng.integers(1, 3, n_ev).astype(np.int32))
            sink.by_chrom[reg.by_name[name].index] = handover(ev)
        sinks.append(sink)
    eng = TorchEngine("cpu")
    eng.begin_run()
    pipeline._replicate_device(eng, reg, sinks[0], sinks[1], p, 0, {},
                               None, "t", "c", True, archive=False)
    stream = files.open_write(p.out_file, p.gz_out)
    pipeline._find_peaks_device(reg, eng, p, stream)
    stream.close()
    assert eng.perf["host_peak_chroms"] == 1
    return out.read_bytes()


@pytest.mark.parametrize("handover", ["ingest", "lists"])
def test_host_route_gets_int64_and_same_output(tmp_path, monkeypatch,
                                               handover):
    """A chromosome over 2^31-1 bp still reaches the exact engine's
    pileups as int64 triples, and its output is the one the all-int64
    hand-over (the pipeline's widening before the staging slots)
    gives."""
    import numpy as np

    from genrich_tpu_torch.engine import pileup
    seen = []
    for fn in ("expt_pileup", "ctrl_frag_terms", "ctrl_pileup"):
        def spy(s, e, c, *a, _real=getattr(pileup, fn), _fn=fn):
            seen[-1].add((_fn, s.dtype.name, e.dtype.name, c.dtype.name))
            return _real(s, e, c, *a)
        monkeypatch.setattr(pileup, fn, spy)
    ways = {"ingest": list, "lists": lambda ev: [a.tolist() for a in ev],
            "int64": lambda ev: [a.astype(np.int64) for a in ev]}
    out = []
    for way in (handover, "int64"):
        seen.append(set())
        out.append(_host_route_output(tmp_path, ways[way]))
    assert out[0] == out[1] and out[0].count(b"chrBig\t") > 0
    assert seen[0] == seen[1] == {(fn, "int64", "int64", "int64") for fn in (
        "expt_pileup", "ctrl_frag_terms", "ctrl_pileup")}

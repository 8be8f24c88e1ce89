"""The replicate archive's and Fisher's combination's spans and counters
(``pipeline.archive`` / ``archive_s``, ``archive_rows``;
``pipeline.fisher`` / ``fisher_s``, ``fisher_rows``) on the CPU.

A small analysis of the benchmark's ChIP configuration (``-r``, two
treatment replicates each with its input control, three short
chromosomes) runs through ``pipeline._replicate_device`` and
``pipeline._find_peaks_device`` on ``TorchEngine("cpu")`` and on
``ShardedTorchEngine("cpu", n_shards=8)``, as ``portbench/harness.py``
runs them.  Checked: the four keys are filled; ``archive_rows`` is
what each archive kept and ``fisher_rows`` the archived runs that
reach the merge, both counted here from the engine's own replicate
archive; with one replicate every key stays 0 and neither span is
entered; under ``torch.profiler`` both names are ``record_function``
ranges around their dispatches, and without a profiler none is made.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import conftest  # noqa: F401
import oracle

from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from portbench import harness

SEED = 2 ** 31 + 7
KEYS = ("archive_s", "fisher_s", "archive_rows", "fisher_rows")
SPANS = ("pipeline.archive", "pipeline.fisher")


def _tiny(replicates=2):
    """The benchmark's ChIP configuration on three chromosomes of about
    250 kbp at a thousandth of its depth, with strong sites; the first
    ``replicates`` replicates (each a treatment and its control)."""
    with open(os.path.join(oracle.REPO, "portbench", "configs",
                           "chip_tf_encode.json")) as f:
        cfg = json.load(f)
    cfg["genome"] = [[n, max(ln // 1000, 20000)]
                     for n, ln in cfg["genome"]][:3]
    cfg["sample"]["files"] = [f for f in cfg["sample"]["files"]
                              if f["replicate"] < replicates]
    for f in cfg["sample"]["files"]:
        f["pairs"] = f["pairs"] // 1000
    cfg["sample"]["sites"].update(count=10, frip=0.6)
    return cfg


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return harness.Cell(_tiny(), {"pool": 1}, SEED, "cpu",
                        str(tmp_path_factory.mktemp("chip")))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return harness.Cell(_tiny(1), {"pool": 1}, SEED, "cpu",
                        str(tmp_path_factory.mktemp("single")))


def _engine(kind):
    return TorchEngine("cpu") if kind == "jax" \
        else ShardedTorchEngine("cpu", n_shards=8)


def _kept(kind, rep):
    """The rows of one replicate's archive entry, over its device
    chromosomes: each chromosome's kept runs (TorchEngine), or every
    card's padded tiles (the sharded engine)."""
    if kind == "jax":
        return sum(e[0].shape[0] for e in rep.values())
    return sum(t.numel() for e in rep.values() for t in e[0])


def _spy(eng, kind, seen):
    """Wrap ``eng``'s archive and Fisher steps: ``seen`` gets, for each
    archive, the new ``archive_rows`` beside the rows the archive
    holds, and before Fisher the rows of every archived replicate
    beside the change in ``fisher_rows``."""
    archive, fisher = eng.archive_replicate, eng.finalize_fisher

    def archive_replicate():
        before = eng.perf["archive_rows"]
        archive()
        seen.append(("archive", eng.perf["archive_rows"] - before,
                     _kept(kind, eng._reps[-1])))

    def finalize_fisher():
        want = sum(_kept(kind, rep) for rep in eng._reps)
        before = eng.perf["fisher_rows"]
        fisher()
        seen.append(("fisher", eng.perf["fisher_rows"] - before, want))
    eng.archive_replicate = archive_replicate
    eng.finalize_fisher = finalize_fisher


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_keys_filled_and_rows_counted(cell, kind):
    eng = _engine(kind)
    seen = []
    _spy(eng, kind, seen)
    rec = cell.analysis(eng, 0, harness.Spans(False))
    perf = rec["perf"]
    assert perf["archive_s"] > 0 and perf["fisher_s"] > 0
    assert [s[0] for s in seen] == ["archive", "archive", "fisher"]
    for step, got, want in seen:
        assert got == want > 0, (step, got, want)
    assert perf["archive_rows"] == seen[0][1] + seen[1][1]
    assert perf["fisher_rows"] == seen[2][1]
    if kind == "jax":
        # TorchEngine combines exactly the runs its archives kept
        assert perf["fisher_rows"] == perf["archive_rows"]
    # a parent of the dispatches inside it, not a further leaf
    assert perf["archive_s"] + perf["fisher_s"] \
        <= sum(rec["spans"][k] for k in ("pipeline._replicate_device",
                                         "pipeline._find_peaks_device"))


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_counters_reset_each_analysis(cell, kind):
    eng = _engine(kind)
    first = cell.analysis(eng, 0, harness.Spans(False))["perf"]
    second = cell.analysis(eng, 0, harness.Spans(False))["perf"]
    for key in ("archive_rows", "fisher_rows"):
        assert second[key] == first[key] > 0, key


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("pipeline.")]


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_one_replicate_leaves_keys_zero(single, kind):
    eng = _engine(kind)
    single.analysis(eng, 0, harness.Spans(False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = single.analysis(eng, 0, harness.Spans(True))
    for key in KEYS:
        assert rec["perf"][key] == 0, key
    names = {n for n, _, _ in _events(prof)}
    assert "pipeline._replicate_device" in names
    assert not names & set(SPANS), names & set(SPANS)


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_profiler_names_archive_and_fisher(cell, kind):
    eng = _engine(kind)
    cell.analysis(eng, 0, harness.Spans(False))       # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            cell.analysis(eng, 0, harness.Spans(True))
    events = _events(prof)
    spans = {name: [(s, t) for n, s, t in events if n == name]
             for name in SPANS}
    assert len(spans["pipeline.archive"]) == 2        # one a replicate
    assert len(spans["pipeline.fisher"]) == 1
    program = {"jax": {"pipeline.archive": "pipeline.dispatch.rle_pv",
                       "pipeline.fisher": "pipeline.dispatch.merge_fisher"},
               "sharded": {"pipeline.archive": "pipeline.dispatch.rle_pv",
                           "pipeline.fisher": "pipeline.dispatch.fisher"}}
    for name, inner in program[kind].items():
        inside = [(s, t) for n, s, t in events if n == inner]
        assert inside, inner
        for s, t in inside:
            assert any(a <= s and t <= b for a, b in spans[name]), inner
    if kind == "jax":
        # the archive's one pull of its run counts lies inside it
        waits = [(s, t) for n, s, t in events if n == "pipeline.fetch.wait"]
        assert sum(any(a <= s and t <= b for a, b in spans[
            "pipeline.archive"]) for s, t in waits) == 2


def test_no_record_function_without_profiler(cell, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = TorchEngine("cpu")
    rec = cell.analysis(eng, 0, harness.Spans(False))
    assert entered == [] and rec["perf"]["fisher_s"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        cell.analysis(eng, 0, harness.Spans(False))
    assert set(SPANS) <= set(entered)

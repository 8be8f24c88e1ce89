"""The ChIP cell, ``chip_tf_encode.device``, and its four per-layer
metrics: the cell loads; ``run.metric_entries`` gives it exactly the
four and leaves the ATAC cell's list as it was; the readers' means on
a synthetic run record, and nothing on the record of a program without
the keys (or, for K3's roofline share, without a whole set of K3
records); the tiny cell run through the harness on the CPU gives the
three counters' readers values."""

import pytest

from portbench import harness, run as runmod
from portbench.roofline import bound_s

NEW = ["engine.archive_s", "engine.fisher_s", "engine.fisher_rows",
       "fisher_combine_roofline"]
ATAC = ["pairs_per_s.traced", "analysis_s.p50", "pipeline.replicate_s",
        "pipeline.findpeaks_s", "engine.upload_s", "engine.fetches",
        "ops.device_ms", "kernels_roofline", "device.idle_pct",
        "engine.cast_s", "engine.dispatch_s", "engine.fetch_wait_s",
        "engine.qvalue_merge_s", "pipeline.peak_write_s",
        "pipeline.unspanned_s"]
END_TO_END = ["analysis_s.p95", "peak_device_mb", "setup_s"]


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


def test_cell_loads():
    bench, cell, config, traffic = harness.load_cell("chip_tf_encode.device")
    assert cell["config"] == "chip_tf_encode" and cell["chips"] == 1
    assert traffic == {"pool": 2}
    assert config["name"] == "chip_tf_encode"
    assert sum(f["pairs"] for f in config["sample"]["files"]) == 80_000_000
    assert config["flags"] == "-r" and "-p" not in config["flags"]
    entry = {c["name"]: c for c in bench["configs"]}["chip_tf_encode"]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


@pytest.mark.parametrize("cell,trace,want", [
    ("chip_tf_encode.device", 1, NEW),
    ("atac_published.device", 1, ATAC),
    ("chip_tf_encode.device", 0, END_TO_END),
    ("atac_published.device", 0, END_TO_END),
])
def test_metric_entries(cell, trace, want):
    bench, c, _, _ = harness.load_cell(cell)
    got = [m["name"] for m in runmod.metric_entries(bench, c, trace)]
    assert got == want
    for name in got:
        assert (harness.ROOT / "metrics" / f"{name}.py").is_file(), name


def _rec(**perf):
    return {"spans": {}, "perf": perf}


def test_counter_readers():
    run = {"recs": [_rec(archive_s=0.02, fisher_s=0.05, fisher_rows=100),
                    _rec(archive_s=0.04, fisher_s=0.07, fisher_rows=300)]}
    want = {"engine.archive_s": 0.03, "engine.fisher_s": 0.06,
            "engine.fisher_rows": 200}
    for name, v in want.items():
        assert _reader(name).read(run) == pytest.approx(v), name
    # the parent's records: the engine has none of the keys
    parent = {"recs": [_rec(upload_s=0.1, fetch_n=31)]}
    for name in want:
        assert _reader(name).read(parent) is None, name
        assert _reader(name).read({"recs": []}) is None, name


def _trace(calls, records=None, device_ns=2_000_000):
    work = [{"bytes": 12 * n, "fp32_ops": 0, "fp64_ops": 0}
            for _, n in calls]
    return {"trace": {"hand": {
        "fisher_combine": {"device_ns": device_ns,
                           "records": len(calls) if records is None
                           else records,
                           "calls": len(calls), "per_call": 1,
                           "work": work},
        "tile_stats": {"device_ns": 5, "records": 7, "calls": 1,
                       "per_call": 2, "work": []}}}}


def test_fisher_combine_roofline():
    read = _reader("fisher_combine_roofline").read
    calls = [(2, 2_000_000), (2, 1_000_000)]
    # K2's records differ from its calls: K3's share is read all the same
    want = 100.0 * sum(bound_s(12 * n) for _, n in calls) / 2e-3
    assert read(_trace(calls)) == pytest.approx(want)
    assert 0 < want < 100
    assert read(_trace(calls, records=3)) is None      # dropped / extra
    assert read(_trace([], records=0)) is None         # K3 never ran
    assert read(_trace([], records=1)) is None
    assert read(_trace(calls, device_ns=0)) is None
    assert read({"trace": None}) is None
    assert read({"trace": {"hand": {}}}) is None


def test_tiny_cell_reads_counters(tiny_cfg, tmp_path):
    r = harness.run_cell({"name": "tiny", "chips": 1},
                         tiny_cfg("chip_tf_encode"), {"pool": 2},
                         2 ** 31 + 11, 0.01, 0, "cpu",
                         tmpdir=str(tmp_path))
    assert r["failed"] == 0 and r["recs"], r["errors"]
    assert runmod.judge(r)[0], runmod.judge(r)[1]
    for name in NEW[:3]:
        assert _reader(name).read(r) > 0, name
    assert _reader("fisher_combine_roofline").read(r) is None

"""The hand kernels' work from shapes (``portbench/kernels``), held to
the port's own counters (``genrich_tpu_torch.testing``) and to the
main-path counts in PERF.md §6; the recording of their calls; the
trace's union and idle gaps."""

import types

import pytest
import torch

from portbench import harness, trace
from portbench.roofline import bound_s

KERN = {k.NAME: k for k in (harness.load_module(p) for p in sorted(
    (harness.ROOT / "kernels").glob("*.py")))}


def test_five_kernels():
    assert set(KERN) == {"coverage_scan", "tile_stats", "fisher_combine",
                         "gap_join", "peak_reduce"}


@pytest.mark.parametrize("m", [1, 4097, 2_520_000])
def test_work_matches_the_ports_counters(m):
    from genrich_tpu_torch import testing
    k = 32768
    w = KERN["coverage_scan"].work((m, 2, False))
    assert w["bytes"] == testing.scan_bytes(m, 2, None)
    assert w["fp32_ops"] == testing.coverage_scan_opcount(m, 2)["fp32_ops"]
    assert KERN["tile_stats"].work(m)["bytes"] == testing.stats_bytes(m)
    assert KERN["gap_join"].work((m, k))["bytes"] \
        == testing.gap_join_bytes(m, k)
    first = torch.tensor([0, 10, 40, 5])
    last = torch.tensor([7, 30, 39, 5])
    rec = KERN["peak_reduce"].record(None, None, None, None, None, None,
                                     first, last, 2.0)
    assert KERN["peak_reduce"].work(rec)["bytes"] \
        == testing.peak_reduce_bytes(first, last)


def _candidates(n, rows, k):
    """K4's recorded (first, last) of ``k`` slots, the last ``n`` of
    them candidates of ``rows`` rows each (the rest empty: 0, -1)."""
    first = torch.zeros(k, dtype=torch.int64)
    last = torch.full((k,), -1, dtype=torch.int64)
    first[-n:] = torch.arange(n) * rows
    last[-n:] = first[-n:] + rows - 1
    return first, last


# PERF.md §6, main path (3 chromosomes) and Fisher: MB a path
@pytest.mark.parametrize("name,calls,mb", [
    ("coverage_scan", [(2_520_000, 2, False)] * 3, 90.7),
    ("tile_stats", [1_110_000] * 3, 43.3),
    ("fisher_combine", [(2, 2_220_000)] * 3, 79.9),
    ("gap_join", [(1_110_000, 32768)] * 3, 51.7),
    ("peak_reduce", [_candidates(120, 794, 32768)] * 3, 7.6),
])
def test_work_matches_perf_md(name, calls, mb):
    got = sum(KERN[name].work(c)["bytes"] for c in calls) / 1e6
    assert got == pytest.approx(mb, rel=0.01)


def test_bound_is_the_slower_unit():
    assert bound_s(3.35e12) == pytest.approx(1.0)
    assert bound_s(0, fp64_ops=34e12) == pytest.approx(1.0)
    assert bound_s(1.0, fp32_ops=67e12) == pytest.approx(1.0)


def test_recording_wraps_and_restores():
    mod = types.ModuleType("portbench_fake_ops")
    mod.launch = lambda x, k: x * k
    import sys
    sys.modules["portbench_fake_ops"] = mod
    kern = types.SimpleNamespace(ENTRY=("portbench_fake_ops", "launch"),
                                 record=lambda x, k: (x, k))
    calls = []
    try:
        with trace.recording(kern, calls):
            assert mod.launch(3, 4) == 12
        assert mod.launch(5, 6) == 30
        assert calls == [(3, 4)]
        missing = types.SimpleNamespace(ENTRY=("portbench_fake_ops", "gone"),
                                        record=None)
        with trace.recording(missing, calls):
            pass
    finally:
        del sys.modules["portbench_fake_ops"]


class _Ev:
    def __init__(self, kind, name, s, e):
        self.k, self.n, self.s, self.e = kind, name, s, e

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_reduce_busy_idle_and_gaps():
    evs = [_Ev("user_annotation", "portbench.window", 0, 1000),
           _Ev("user_annotation", "portbench.analysis", 0, 700),
           _Ev("user_annotation", "pipeline._replicate_device", 100, 500),
           _Ev("kernel", "coverage_scan_kernel(int const*)", 200, 300),
           _Ev("kernel", "void at::native::sort_kernel<int>()", 250, 400),
           _Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120, 180),
           _Ev("kernel", "gap_join_kernel(int const*)", 600, 650)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    kern = [KERN["coverage_scan"], KERN["gap_join"]]
    calls = {"coverage_scan": [(1000, 2, False)], "gap_join": []}
    tr = trace.reduce(prof, kern, calls, 1)
    assert tr["busy_s"] == pytest.approx((60 + 200 + 50) / 1e9)
    assert tr["window_s"] == pytest.approx(1e-6)
    assert tr["ops_ns"] == 150          # the sort alone
    assert tr["hand"]["coverage_scan"]["device_ns"] == 100
    idle = dict(tr["breakdown"]["idle_gaps"])
    # gaps [0, 120), [180, 200), [400, 600), [650, 1000) by their middle
    assert idle == pytest.approx({"pipeline._replicate_device": 20e-9,
                                  "portbench.analysis": 320e-9,
                                  "portbench.window": 350e-9})


def _tr(records, calls, per_call=1):
    w = {"bytes": 3.35e6, "fp32_ops": 0, "fp64_ops": 0}     # 1 us
    return {"trace": {"hand": {
        "gap_join": {"device_ns": 4000, "records": 2, "calls": 2,
                     "per_call": 1, "work": [w, w]},
        "peak_reduce": {"device_ns": 3000 if records else 0,
                        "records": records, "calls": calls,
                        "per_call": per_call, "work": [w] * calls}}}}


@pytest.mark.parametrize("records,calls,want", [
    (2, 2, 100.0 * 4 / 7),      # every kernel whole
    (1, 2, None),               # the profiler dropped a record
    (2, 0, None),               # calls past the recorded entry
    (0, 0, 100.0 * 2 / 4),      # a kernel off the path
])
def test_roofline_over_every_kernel_or_none(records, calls, want):
    got = harness.load_module(harness.ROOT / "metrics" /
                              "kernels_roofline.py").read(_tr(records, calls))
    assert got == (None if want is None else pytest.approx(want))


def test_peak_reduce_record_launches_nothing():
    first, last = _candidates(3, 5, 8)
    rec = KERN["peak_reduce"].record(None, None, None, None, None, None,
                                     first, last, 2.0)
    assert rec[0] is first and rec[1] is last
    assert KERN["peak_reduce"].work(rec)["bytes"] == 13 * 15 + 40 * 8

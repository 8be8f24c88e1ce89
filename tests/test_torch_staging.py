"""The event staging of ``TorchEngine`` (``engine/staging.EventStager``).

On the CPU: the staged tensors equal, bitwise, what the engine uploaded
before the staging slots (the pipeline's int64 widening, then
``np.asarray(x, np.int32)`` and ``np.asarray(x, np.uint8)``) for every
hand-over in ``HANDOVERS``, with starts at 0 and 2^31-1 and codes that
wrap (256), and at 200,001 events, past ATen's grain, on 1 and 4
intra-op threads with values that wrap both ways; a layout torch cannot
view raises; no tensor handed out shares memory with a slot, and a slot
rewritten later leaves earlier tensors as they were; ``stage_alloc_n``
counts slot growth only, ``stage_bytes`` the events' share of
``upload_bytes``, and ``begin_run`` resets the three keys.  On a card
(skipped without one): many triples staged back to back through the
pinned slots arrive intact, the benchmark's analysis writes the same
narrowPeak bytes as through pageable uploads over three analyses that
reuse the slots, and the profiler sees no pageable host-to-device copy
of an event array.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import oracle

from genrich_tpu_torch.engine.perf import span
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from portbench import harness

I32_MAX = 2 ** 31 - 1
STAGE_KEYS = ("stage_bytes", "stage_alloc_n", "stage_wait_s")
SEED = 2 ** 31 + 21


def _ingest(n, seed):
    """An event triple as native ingest hands it over: int64 starts and
    ends, int32 count codes; starts at 0 and 2^31-1, ends past 2^31-1,
    codes 0, 1, 120, 255 and 256."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, I32_MAX, n, dtype=np.int64)
    starts[:2] = 0, I32_MAX
    ends = starts + rng.integers(1, 500, n)
    codes = rng.integers(1, 300, n).astype(np.int32)
    codes[:5] = 0, 1, 120, 255, 256
    return starts, ends, codes


HANDOVERS = {
    "ingest": lambda ev: ev,
    "int64": lambda ev: tuple(a.astype(np.int64) for a in ev),
    "lists": lambda ev: tuple(a.tolist() for a in ev),
    "strided": lambda ev: tuple(np.repeat(a, 2)[::2] for a in ev),
}
# Layouts that torch.from_numpy cannot view, which ingest never makes.
UNVIEWABLE = {
    "reversed": lambda ev: tuple(a[::-1].copy()[::-1] for a in ev),
    "big_endian": lambda ev: tuple(
        a.astype(a.dtype.newbyteorder(">")) for a in ev),
}


def _before(ev):
    """What the engine uploaded before the staging slots: the pipeline's
    int64 widening, then ``_events``' casts."""
    wide = [np.asarray(a, np.int64) for a in ev]
    return (np.asarray(wide[0], np.int32), np.asarray(wide[1], np.int32),
            np.asarray(wide[2], np.uint8))


def _equal(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _slot_ranges(eng):
    return [(h.data_ptr(), h.data_ptr() + h.nbytes)
            for s in eng._stager._slots if s is not None for h in s.host]


@pytest.mark.parametrize("handover", sorted(HANDOVERS))
def test_staged_bitwise_to_casts(handover):
    ev = _ingest(3001, 1)
    eng = TorchEngine("cpu")
    _equal(eng._events(HANDOVERS[handover](ev)), _before(ev))
    assert np.asarray(_before(ev)[2])[:5].tolist() == [0, 1, 120, 255, 0]


@pytest.mark.parametrize("threads", [1, 4])
def test_staged_bitwise_past_the_grain(threads):
    rng = np.random.default_rng(threads)
    n = 200_001
    ev = (rng.integers(-2 ** 40, 2 ** 40, n, dtype=np.int64),
          rng.integers(-2 ** 40, 2 ** 40, n, dtype=np.int64),
          rng.integers(-5, 401, n).astype(np.int32))
    eng = TorchEngine("cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = eng._events(ev)
    finally:
        torch.set_num_threads(before)
    _equal(got, _before(ev))


@pytest.mark.parametrize("layout", sorted(UNVIEWABLE))
def test_unviewable_layout_raises(layout):
    ev = UNVIEWABLE[layout](_ingest(1000, 6))
    with pytest.raises(ValueError):
        TorchEngine("cpu")._events(ev)


def test_no_tensor_aliases_a_slot():
    eng = TorchEngine("cpu")
    evs = [_ingest(n, s) for s, n in enumerate((2000, 1500, 1800, 900))]
    got = [eng._events(ev) for ev in evs]      # slots 0, 1, 0, 1
    for ev, ts in zip(evs, got):
        _equal(ts, _before(ev))
        for t in ts:
            p = t.untyped_storage().data_ptr()
            assert all(not lo <= p < hi for lo, hi in _slot_ranges(eng))


def test_slots_grow_only_for_a_larger_chromosome():
    eng = TorchEngine("cpu")
    small, big = _ingest(1000, 2), _ingest(800, 3)
    for _ in range(2):
        eng.begin_run()
        eng._events(small)
        eng._events(big)
    assert eng.perf["stage_alloc_n"] == 0
    assert eng.perf["stage_bytes"] == 9 * 1800 == eng.perf["upload_bytes"]
    assert eng.perf["upload_n"] == 6
    eng.begin_run()
    eng._events(small)
    eng._events(_ingest(5000, 4))
    assert eng.perf["stage_alloc_n"] == 1
    assert eng.perf["stage_wait_s"] == 0.0       # no event on the CPU


def test_begin_run_resets_stage_keys():
    eng = TorchEngine("cpu")
    assert all(eng.perf[k] == 0 for k in STAGE_KEYS)
    eng._events(_ingest(100, 5))
    assert eng.perf["stage_bytes"] == 900 and eng.perf["stage_alloc_n"] == 1
    eng.perf["stage_wait_s"] = 1.0
    eng.begin_run()
    assert all(eng.perf[k] == 0 for k in STAGE_KEYS)


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


def _triples(cell, index):
    """The lengths of pool sample ``index``'s non-empty event triples."""
    reps, _ = cell.pool[index]
    return [len(a[0]) for treat, ctrl in reps for ev in (treat, ctrl)
            if ev is not None for a in ev.values() if len(a[0])]


def test_analysis_allocates_nothing_after_warmup(tmp_path):
    cell = harness.Cell(_tiny(), {"pool": 1}, SEED, "cpu", str(tmp_path))
    eng = TorchEngine("cpu")
    first = cell.analysis(eng, 0, harness.Spans(False))
    again = cell.analysis(eng, 0, harness.Spans(False))
    assert first["perf"]["stage_alloc_n"] == 2
    assert again["perf"]["stage_alloc_n"] == 0
    assert again["perf"]["stage_bytes"] == 9 * sum(_triples(cell, 0))
    assert again["output"] == first["output"]


# --- on a card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned slots and non_blocking "
                    "copies exist only there")
    return torch.device("cuda")


class PageableEngine(TorchEngine):
    """``TorchEngine`` with the event uploads it had before the staging
    slots: the pipeline's int64 widening and three casts, then one
    pageable ``torch.as_tensor`` copy an array (``PerfMixin._put``)."""

    def _events(self, ev):
        if ev is None or len(ev[0]) == 0:
            return super()._events(ev)
        with span("pipeline.cast", self.perf, "cast_s"):
            host = _before(ev)
        return tuple(self._put(a) for a in host)


def test_card_pinned_slots_back_to_back(cuda):
    eng = TorchEngine(cuda)
    evs = [_ingest(1 << 20, s) for s in range(8)]
    got = [eng._events(ev) for ev in evs]
    torch.cuda.synchronize()
    for ev, ts in zip(evs, got):
        _equal(ts, _before(ev))
    assert all(s.host[0].is_pinned() for s in eng._stager._slots)
    assert eng.perf["stage_alloc_n"] == 2
    assert eng.perf["stage_bytes"] == 8 * 9 * (1 << 20)


def _memcpys(prof, kind):
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith(f"Memcpy HtoD ({kind}"))


def test_card_pinned_path_writes_pageable_bytes(cuda, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg = _tiny()
    cell = harness.Cell(cfg, {"pool": 2}, SEED, cuda, str(tmp_path))
    runs, copies = {}, {}
    for kind, eng in (("pinned", TorchEngine(cuda)),
                      ("pageable", PageableEngine(cuda))):
        recs = [cell.analysis(eng, i, harness.Spans(False))
                for i in (0, 1, 0)]
        runs[kind] = [r["output"] for r in recs]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rec = cell.analysis(eng, 1, harness.Spans(False))
            torch.cuda.synchronize()
        copies[kind] = (_memcpys(prof, "Pageable"), _memcpys(prof, "Pinned"),
                        [r["perf"] for r in recs] + [rec["perf"]])
    assert runs["pinned"] == runs["pageable"]
    pageable, pinned, perfs = copies["pinned"]
    base, _, base_perfs = copies["pageable"]
    assert [p["stage_alloc_n"] for p in perfs[2:]] == [0, 0]
    # every event triple left the pageable copies for pinned ones
    triples = len(_triples(cell, 1))
    assert pageable == base - 3 * triples and pinned >= 3 * triples > 0
    perf, base_perf = perfs[-1], base_perfs[-1]
    assert perf["stage_bytes"] == 9 * sum(_triples(cell, 1)) > 0
    for key in ("upload_n", "upload_bytes"):
        assert perf[key] == base_perf[key], key

"""The sample generator: a seed gives the same events, another seed
other events of the same counts, and the events look like the port's
ingest output (int64 positions, int32 count codes, file order); the
traffic file's order and depth."""

import numpy as np
import pytest
import torch

from portbench import generate, harness


def _flat(sample):
    reps, pairs = sample
    return pairs, [(name, arr) for treat, ctrl in reps
                   for ev in (treat, ctrl) if ev is not None
                   for name, arrs in sorted(ev.items()) for arr in arrs]


def test_same_seed_same_events(tiny_cfg):
    cfg = tiny_cfg("chip_tf_encode")
    a = _flat(generate.sample(cfg, 2 ** 31 + 11, 0, "cpu"))
    b = _flat(generate.sample(cfg, 2 ** 31 + 11, 0, "cpu"))
    assert a[0] == b[0]
    for (na, x), (nb, y) in zip(a[1], b[1]):
        assert na == nb and np.array_equal(x, y)


def test_other_seed_other_events_same_counts(tiny_cfg):
    cfg = tiny_cfg("atac_published")
    _, a = _flat(generate.sample(cfg, 5, 0, "cpu"))
    _, b = _flat(generate.sample(cfg, 6, 0, "cpu"))
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    # the same fragments a chromosome: ATAC's cut sites differ only
    # where a fragment is short enough for its two windows to merge
    for (_, x), (_, y) in zip(a[2::3], b[2::3]):
        assert abs(len(x) - len(y)) <= 0.05 * len(x) + 10


def test_pool_samples_differ(tiny_cfg):
    cfg = tiny_cfg("atac_published")
    _, a = _flat(generate.sample(cfg, 5, 0, "cpu"))
    _, b = _flat(generate.sample(cfg, 5, 1, "cpu"))
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_events_as_ingest_hands_them(tiny_cfg):
    cfg = tiny_cfg("atac_published")
    (reps, pairs) = generate.sample(cfg, 7, 0, "cpu")
    treat, ctrl = reps[0]
    assert ctrl is None and pairs == cfg["sample"]["files"][0]["pairs"]
    lengths = dict(cfg["genome"])
    assert set(treat) == {n for n, _ in generate.analysed(cfg)}
    for name, (s, e, n) in treat.items():
        assert s.dtype == np.int64 and e.dtype == np.int64
        assert n.dtype == np.int32
        assert set(np.unique(n)) <= {1, 2, 3, 4}
        assert (s >= 0).all() and (e <= lengths[name]).all()
        assert (e > s).all()
        assert not (np.diff(s) >= 0).all()       # file order, not sorted


def test_exclusions_fixed_bp(tiny_cfg):
    cfg = tiny_cfg("atac_published")
    a = generate.exclusions(cfg, 1)
    b = generate.exclusions(cfg, 2)
    assert a != b
    for name in a:
        assert sum(e - s for s, e in a[name]) == sum(e - s
                                                     for s, e in b[name])
        regs = sorted(a[name])
        assert all(x[1] <= y[0] for x, y in zip(regs, regs[1:]))


def test_shares_are_exact():
    assert generate.shares(10, [1, 1, 1]) == [4, 3, 3]
    assert sum(generate.shares(60_000_000, [3, 5, 7, 11])) == 60_000_000


def test_generator_runs_on_the_given_device(tiny_cfg):
    cfg = tiny_cfg("chip_tf_encode")
    reps, _ = generate.sample(cfg, 3, 0, torch.device("cpu"))
    assert len(reps) == 2 and all(c is not None for _, c in reps)


def test_schedule_cycles_or_draws_from_the_seed():
    from itertools import islice
    assert list(islice(harness.schedule({"pool": 3}, 7, 3), 7)) \
        == [0, 1, 2, 0, 1, 2, 0]
    seeded = {"pool": 3, "order": "seeded"}
    a = list(islice(harness.schedule(seeded, 2 ** 31 + 9, 3), 40))
    assert a == list(islice(harness.schedule(seeded, 2 ** 31 + 9, 3), 40))
    assert a != list(islice(harness.schedule(seeded, 2 ** 31 + 8, 3), 40))
    assert set(a) == {0, 1, 2}
    with pytest.raises(ValueError):
        next(harness.schedule({"order": "burst"}, 1, 3))


def test_depth_scales_every_file(tiny_cfg):
    cfg = tiny_cfg("chip_tf_encode")
    assert harness.with_depth(cfg, 1) is cfg
    half = harness.with_depth(cfg, 0.5)
    assert [f["pairs"] for f in half["sample"]["files"]] \
        == [round(f["pairs"] / 2) for f in cfg["sample"]["files"]]
    assert half["genome"] == cfg["genome"]

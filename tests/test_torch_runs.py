"""The device engines' interval rows against the exact engine's intervals.

``compact.pileup_runs`` merges the rows of ``tile_coverage`` (one per
event position) into maximal runs, the intervals of the exact engine's
p-value pileup: ``engine/pileup.py``'s treatment and control pileups
merged by ``engine/pvalue.py::merge_pileups`` (the port's copies of the
JAX package's host modules; the merge has no JAX twin, the JAX engines
keep one row per event).  Held bitwise: each interval's (start, end),
its exclusion flag, its treatment value and its control value
max(factor * raw, lambda), on every chromosome, for no control, a
control, -E with adjacent regions and both, all with fractional
weights (count codes 1-10); a treatment far above 2^21, where float32
rounds two values to one and the exact rule still breaks; positions
whose events cancel; the sharded engine's per-tile merge with non-zero
carries, joined across tiles where ``cont`` says a boundary cut an
interval; and the summit of a peak whose longest interval a tile
boundary cuts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from genrich_tpu_torch.engine import pileup as ep
from genrich_tpu_torch.engine import pvalue as epv
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from genrich_tpu_torch.ops import compact
from genrich_tpu_torch.ops.pipeline import tile_class_totals, tile_coverage
from genrich_tpu_torch.parallel import mesh

F32 = np.float32
SKIP = F32(-1.0)
WEIGHTS = (1, 2, 3, 4, 5, 6, 8, 10)     # count codes: weight 1/N
LENS = (40_000, 25_000)
# -E on the first chromosome: two adjacent regions (a boundary inside an
# exclusion) and one more
ADJACENT = [2000, 5000, 5000, 7000, 30_000, 30_500]


def _events(seed, length, n):
    """Clustered fragments with weights 1/N; a quarter of them start
    where others end, so their deltas meet (and often cancel)."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, length - 500, n).astype(np.int64)
    e = np.minimum(s + rng.randint(30, 400, n), length).astype(np.int64)
    k = n // 4
    s[:k] = e[k:2 * k]
    e[:k] = np.minimum(s[:k] + rng.randint(30, 400, k), length)
    keep = e > s
    c = rng.choice(WEIGHTS, n).astype(np.int64)
    o = np.argsort(s[keep], kind="stable")
    return s[keep][o], e[keep][o], c[keep][o]


def _exact(expt, ctrl, length, bed, lam, factor):
    """The exact engine's p-value intervals: (starts, ends, expt value,
    control value; SKIP where excluded)."""
    pu = ep.expt_pileup(*expt, length, bed)[0] if len(expt[0]) \
        else ep.const_pileup(length, F32(0.0))
    cu = ep.ctrl_pileup(*ctrl, length, bed, factor, lam) \
        if ctrl is not None else ep.lambda_pileup(length, bed, lam)
    ends, ev, cv = epv.merge_pileups(pu, cu)
    return np.concatenate([[0], ends[:-1]]), ends, ev, cv


def _rows(st, lam, factor):
    """A TorchEngine chromosome's live rows after ``stats_all``, as the
    exact engine would print them: (starts, ends, expt, control)."""
    lv = st["live"].numpy()
    x = st["excluded"].numpy()[lv]
    ev = st["ev"].numpy()[lv]
    net = np.maximum(factor * st["cr"].numpy()[lv], lam)
    return (st["starts"].numpy()[lv], st["ends"].numpy()[lv],
            np.where(x, F32(0.0), ev), np.where(x, SKIP, net))


def _assert_exact(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(np.asarray(g).astype(w.dtype)
                                      .view(np.uint8), w.view(np.uint8))


def _run(eng, expt, ctrl, beds):
    handles = [eng.coverage_chrom(i, expt[i], ctrl[i], beds[i], n)
               for i, n in enumerate(LENS)]
    frag, cfrag = eng.coverage_finish(handles)
    lam = ep.calc_lambda(frag, sum(LENS))
    factor = ep.calc_factor(frag, cfrag)
    eng.stats_all(float(lam), float(factor))
    return lam, factor


CASES = {"none": (False, False), "ctrl": (True, False),
         "excl": (False, True), "ctrl_excl": (True, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_engine_rows_are_exact_intervals(case):
    with_ctrl, with_excl = CASES[case]
    expt = [_events(1 + i, n, 900) for i, n in enumerate(LENS)]
    ctrl = [_events(11 + i, n, 300) if with_ctrl else None
            for i, n in enumerate(LENS)]
    beds = [ADJACENT if with_excl else [], []]
    eng = TorchEngine("cpu")
    lam, factor = _run(eng, expt, ctrl, beds)
    for i, n in enumerate(LENS):
        want = _exact(expt[i], ctrl[i], n, beds[i], lam, factor)
        _assert_exact(_rows(eng._chrom[i], lam, factor), want)
        if with_excl and i == 0:
            assert (want[3] == SKIP).sum() == 3     # 5000 breaks, twice
    p = eng.perf
    # the merge's teeth: rows that were pieces of one interval
    assert p["merged_rows"] == p["merged_width"] < p["real_rows"] \
        < p["interval_rows"]
    eng.release()


def test_large_carry_breaks_where_float32_does_not():
    """Coverage of 2^24 entering the tile (a carry), then eighths: the
    values 2^24 + k/8 share one float32, yet each is an interval of the
    exact engine, whose breaks (non-zero entries) do not depend on the
    value below them."""
    length = 20_000
    rng = np.random.RandomState(5)
    pos = np.sort(rng.choice(np.arange(1, length - 300), 240,
                             replace=False))
    s, e = pos[:120], pos[:120] + rng.randint(50, 300, 120)
    c = np.full(120, 8, np.int64)
    z = torch.zeros(0, dtype=torch.int32)
    carry = torch.tensor([1 << 24, 0, 0, 0], dtype=torch.int32)
    excl = torch.full((1, 2), length, dtype=torch.int32)
    out = tile_coverage(torch.from_numpy(s).int(), torch.from_numpy(e).int(),
                        torch.from_numpy(c), z, z, z.to(torch.uint8), excl,
                        length, carry, torch.zeros(4, dtype=torch.int32),
                        levels=True)
    starts, ends, ev, cr, x, live = out[:6]
    r = compact.pileup_runs(starts, ends, ev, cr, x, live, out[8], excl,
                            F32(0.5), F32(1.0))
    n = int(r.n)
    want = ep.expt_pileup(s, e, c, length, [])[0].end
    np.testing.assert_array_equal(r.ends[:n].numpy(), want)
    v = r.ev[:n].numpy()
    assert (v[1:] == v[:-1]).sum() > 50     # equal float32, distinct runs
    assert bool((r.level[1:n] != r.level[:n - 1]).all())
    assert int(r.level[0]) == 120 << 24


def test_cancelling_events_merge():
    """A fragment that ends where another of the same weight starts
    leaves the pileup unchanged: one interval of the exact engine, two
    rows of tile_coverage."""
    length = 1000
    s = np.array([100, 200, 300, 400, 600, 650], np.int64)
    e = np.array([200, 300, 400, 500, 650, 700], np.int64)
    c = np.array([1, 1, 2, 2, 1, 3], np.int64)
    eng = TorchEngine("cpu")
    h = eng.coverage_chrom(0, (s, e, c), None, [], length)
    frag, _ = eng.coverage_finish([h])
    lam = ep.calc_lambda(frag, length)
    eng.stats_all(float(lam), 1.0)
    got = _rows(eng._chrom[0], lam, F32(1.0))
    want = _exact((s, e, c), None, length, [], lam, F32(1.0))
    _assert_exact(got, want)
    # no break at 200 (weight 1 ends and starts) and 400 (1/2 ends and
    # starts); at 650 weight 1 ends and 1/3 starts
    assert got[1].tolist() == [100, 300, 500, 600, 650, 700, 1000]
    assert eng.perf["real_rows"] == 9 and eng.perf["merged_rows"] == 7


TL = 4096
N_TILES = 8


def _tile_case():
    """Global events on 6 tiles and a bit of 8: weights 1/N, so the tiles'
    carries are non-zero; an event starting at a tile boundary (no
    continuation there) and adjacent -E regions meeting at another."""
    rng = np.random.RandomState(9)
    length = 6 * TL + 1234
    s = rng.randint(0, length - 400, 2500)
    e = np.minimum(s + rng.randint(30, 1500, 2500), length)
    s[:3], e[:3] = 2 * TL, 2 * TL + 100
    c = rng.choice(WEIGHTS, 2500).astype(np.int64)
    cs = rng.randint(0, length - 300, 600)
    ce = cs + 200
    bed = [1000, 1400, 4 * TL - 100, 4 * TL, 4 * TL, 4 * TL + 80,
           6 * TL - 200, 6 * TL + 300]
    return length, (s, e, c), (cs, ce, np.ones(600, np.int64)), bed


def test_sharded_tile_runs_join_to_exact_intervals():
    length, expt, ctrl, bed = _tile_case()
    kern = mesh.ShardedKernels(TL)
    es, ee, ec = (torch.from_numpy(a) for a in mesh.split_events_to_tiles(
        *expt, N_TILES, TL))
    cs, ce, cc = (torch.from_numpy(a) for a in mesh.split_events_to_tiles(
        *ctrl, N_TILES, TL, pad_to=es.shape[1]))
    excl = torch.from_numpy(mesh.split_excl_to_tiles(bed, N_TILES, TL))
    limit = np.clip(length - np.arange(N_TILES) * TL, 0, TL)
    carries = mesh.exclusive_carries(tile_class_totals(es, ee, ec), None)
    assert bool((carries != 0).any()), "fixture must carry across tiles"
    out = kern.cov(es, ee, ec, cs, ce, cc, excl, limit, levels=True)
    frag = float(out[6].double().sum())
    cfrag = float(out[7].double().sum())
    lam, factor = ep.calc_lambda(frag, length), ep.calc_factor(frag, cfrag)
    bound = torch.from_numpy(np.isin(np.arange(N_TILES) * TL, bed))
    s, e, v, cr, x, n, n_rows, cont = kern.runs(*out[:6], out[8], excl,
                                                bound, lam, factor)
    got = [[], [], [], []]       # chromosome rows: start, end, ev, net
    for t in range(N_TILES):
        k = int(n[t])
        xt = x[t, :k].numpy()
        tile = (s[t, :k].numpy() + t * TL, e[t, :k].numpy() + t * TL,
                np.where(xt, F32(0.0), v[t, :k].numpy()),
                np.where(xt, SKIP, np.maximum(factor * cr[t, :k].numpy(),
                                              lam)))
        for i in range(k):
            if i == 0 and bool(cont[t]):
                # the boundary cut one interval: join its pieces
                assert got[1][-1] == t * TL == tile[0][0]
                assert (got[2][-1], got[3][-1]) == (tile[2][0], tile[3][0])
                got[1][-1] = tile[1][0]
                continue
            for col, a in zip(got, tile):
                col.append(a[i])
    got = [np.array(col) for col in got]
    _assert_exact(got, _exact(expt, ctrl, length, bed, lam, factor))
    # the teeth: intervals cut by a boundary, and boundaries that are
    # breaks (the first tile, events starting at 2 TL, adjacent -E
    # regions meeting at 4 TL, the tile past the chromosome's end)
    cont = cont.tolist()
    assert any(cont) and not any(cont[t] for t in (0, 2, 4, 7))
    assert int(n[7]) == 0 and int(n_rows.sum()) > int(n.sum())


def test_straddling_summit_counts_a_cut_interval_once():
    """The peak's longest interval at its maximum stat lies across the
    tile boundary, 120 bp in two pieces of 60; another interval of that
    stat is 100 bp.  Summit position, p and q as the exact engine's
    updatePeak takes them over uncut intervals: the cut one's midpoint,
    with the p of the first row at the maximum."""
    tl = 4096
    # (start, end, stat) in chromosome coordinates; all significant
    rows = [(3000, 3200, 3.0), (3200, 3300, 7.0), (3300, 4036, 5.0),
            (4036, 4156, 7.0), (4156, 4400, 4.0)]
    tiles = [[], []]
    for s, e, p in rows:
        for t in (0, 1):
            lo, hi = max(s, t * tl), min(e, (t + 1) * tl)
            if hi > lo:
                tiles[t].append((lo - t * tl, hi - t * tl, p))
    width = max(map(len, tiles))

    def col(j, fill, dtype):
        return torch.tensor([[r[j] for r in x] + [fill] * (width - len(x))
                             for x in tiles], dtype=dtype)
    st = {"tile_len": tl, "starts": col(0, tl, torch.int32),
          "ends": col(1, tl, torch.int32), "pv": col(2, 0.0, torch.float32),
          "live": torch.tensor([[i < len(x) for i in range(width)]
                                for x in tiles]),
          "cont": torch.tensor([False, True])}
    # the engine keeps one tensor a card: this engine has one card
    st = {k: [v] if torch.is_tensor(v) else v for k, v in st.items()}
    eng = ShardedTorchEngine("cpu", n_shards=2)
    auc, spv, sqv, spos = eng._row_order_peaks(
        st, np.array([3000]), np.array([4400]), F32(2.0), False)
    assert spos[0] == (4036 + 4156) // 2 - 3000
    assert spv[0] == F32(7.0) and sqv[0] == SKIP
    want = F32(0.0)
    for s, e, p in rows:
        want = F32(want + F32(F32(e - s) * F32(F32(p) - F32(2.0))))
    assert auc[0] == want
    # cut and not joined, the 100-bp interval would win
    st["cont"] = [torch.tensor([False, False])]
    assert eng._row_order_peaks(st, np.array([3000]), np.array([4400]),
                                F32(2.0), False)[3][0] == 3250 - 3000

"""The port's sharded engine against the JAX package's, on the CPU.

``ShardedTorchEngine("cpu", n_shards=8)`` driven through the port's
``pipeline.run`` against ``python -m genrich_tpu --engine sharded`` on
the 8-device virtual CPU mesh (tests/conftest.py), on the six fixtures
of test_engine_jax_cli.py's ``ENGINES`` cases: narrowPeak columns 1-6
identical, columns 7-9 within 1e-5 relative (both are float32 device
paths; sums differ in order), the -f/-k logs by
``testing.check_log``, and column 10 (summit offset) to the port's
``--engine exact`` by ``testing.check_summits`` (equal with one
replicate, whose rows are the exact engine's intervals; with two, equal
or a near tie its -f log shows), not to the JAX twin, whose summit
midpoint wraps in int32 and whose rows break at every event.  One
exception, a fault of the JAX twin: on the big-chromosome
fixture its AUC (column 7, a difference of float32 prefix sums) is
1.08e-5 off the exact engine on one peak, where the port's is 2e-7 off;
there column 7 is held to the exact engine.

Then the steps: ``ShardedKernels.cov`` with non-zero carries against the
JAX ``cov`` step (intervals and masks bitwise, coverage bitwise to the
exact engine's getVal and within 1e-5 of the JAX twin, whose XLA
evaluation of getVal's divisions can round one ulp away; fragment sums
within 1e-5), ``distinct_pvals_k`` against its JAX twin (overflow
included), and peaks that straddle a tile boundary: columns 1-6 equal
``TorchEngine``'s and the exact engine's, column 7 the row-order sum over
``TorchEngine``'s rows, as K4 takes it, and column 10 the exact engine's
(``_row_order_peaks``, an interval cut by the boundary counted once).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)
import jax.numpy as jnp
import torch

from genrich_tpu.ops import compact_jax
from genrich_tpu.parallel import mesh as jmesh
from genrich_tpu_torch import params as tparams
from genrich_tpu_torch import pipeline as tpipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from genrich_tpu_torch.ops import compact
from genrich_tpu_torch.ops.pipeline import tile_class_totals
from genrich_tpu_torch.parallel import mesh as tmesh
from genrich_tpu_torch.testing import check_log, check_summits

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

BASE = ["-o", "out.np", "-y", "-p", "0.01", "-a", "20"]


def _jax_sharded(tmp_path, args):
    d = tmp_path / "jax"
    d.mkdir()
    r = oracle.run_ours(args + ["--engine", "sharded"], cwd=str(d))
    assert r.returncode == 0, r.stderr[-1500:]
    return d


def _port(tmp_path, args, engine=None, name="port"):
    """pipeline.run of the port in this process, on ``engine`` (the
    sharded one by default, "exact" for none); outputs in tmp/name."""
    d = tmp_path / name
    d.mkdir()
    argv = [str(d / a) if i and args[i - 1] in ("-o", "-f", "-k") else a
            for i, a in enumerate(args)]
    perf = {}
    if engine is None:
        engine = ShardedTorchEngine("cpu", n_shards=8)
    tpipeline.run(tparams.parse_args(argv),
                  engine=None if engine == "exact" else engine, perf=perf)
    return d, perf


def _lines(d):
    return (d / "out.np").read_text().splitlines()


def _exact(tmp_path, args):
    """The port's --engine exact on ``args`` in this process, outputs in
    tmp/exact, with an -f log for the summit check unless ``args`` ask
    for one; returns its lines and that log."""
    if "-f" not in args:
        args = args + ["-f", "summit.log"]
    d, _ = _port(tmp_path, args, "exact", "exact")
    return _lines(d), d / args[args.index("-f") + 1]


def _close_rows(want, got, tol=1e-5, auc_ref=None):
    """Columns 1-6 identical, 7-9 within ``tol`` relative; column 7
    against ``auc_ref``'s rows where given."""
    assert want and len(want) == len(got)
    for j, (a, b) in enumerate(zip(want, got)):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7, 8):
            x = float((auc_ref[j] if auc_ref and i == 6 else a)
                      .split("\t")[i])
            y = float(fb[i])
            assert abs(x - y) <= tol * max(1.0, abs(x)), (a, b)


def _fixture(tmp_path, case):
    """(argv without outputs, logs?) of one test_engine_jax_cli case."""
    sam = str(tmp_path / "in.sam")
    if case == "boundaries":
        oracle.random_sam(sam, seed=71)
        return ["-t", sam] + BASE
    if case == "bam":
        oracle.random_sam(sam, seed=77)
        oracle.sam_to_bam(sam, str(tmp_path / "in.bam"))
        return ["-t", str(tmp_path / "in.bam")] + BASE
    if case == "fisher":
        oracle.random_sam(sam, seed=81)
        oracle.random_sam(str(tmp_path / "b.sam"), seed=82, n_pairs=250)
        return ["-t", f"{sam},{tmp_path / 'b.sam'}"] + BASE
    if case == "ctrl_excl":
        oracle.random_sam(sam, seed=72)
        oracle.random_sam(str(tmp_path / "c.sam"), seed=73, cluster=False,
                          n_pairs=150)
        (tmp_path / "x.bed").write_text("chr1\t2000\t9000\n")
        return ["-t", sam] + BASE + ["-c", str(tmp_path / "c.sam"), "-E",
                                     str(tmp_path / "x.bed"), "-q", "0.5"]
    if case == "logs":
        oracle.random_sam(sam, seed=91)
        return ["-t", sam] + BASE + ["-f", "f.log", "-k", "k.log"]
    assert case == "big_chrom"
    oracle.random_sam(sam, chroms=(("chrBig", 3_000_000_000),
                                   ("chr2", 50000)), seed=101, n_pairs=400)
    return ["-t", sam] + BASE + ["-q", "0.5"]


CASES = ["boundaries", "bam", "fisher", "ctrl_excl", "logs", "big_chrom"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_engine_matches_jax_sharded(tmp_path, case):
    args = _fixture(tmp_path, case)
    want_d = _jax_sharded(tmp_path, args)
    got_d, perf = _port(tmp_path, args)
    want, got = _lines(want_d), _lines(got_d)
    exact, log = _exact(tmp_path, args)
    _close_rows(want, got, auc_ref=exact if case == "big_chrom" else None)
    n, ties = check_summits(exact, got, log, 1e-5)
    assert n >= 0.9 * len(exact)
    # one replicate: the rows are the exact engine's intervals
    assert ties == 0 or case == "fisher"
    assert perf["grid_tiles"] % 8 == 0 and perf["dispatch_n"] > 0
    if case == "logs":
        for name in ("f.log", "k.log"):
            check_log(want_d / name, got_d / name)
    if case == "big_chrom":
        assert any(ln.startswith("chrBig\t") for ln in want)
        assert any(int(ln.split("\t")[1]) > 0x7FFFFFFF for ln in want
                   if ln.startswith("chrBig\t"))


# --- the steps -------------------------------------------------------------

TILE_LEN = 4096
N_TILES = 8


def _tile_events(seed):
    """[8, E] tiles of weighted events (count codes 1-10: fractional
    weights make the tiles' class totals, and so the carries, non-zero),
    plus control, exclusions and limits; and the global events."""
    rng = np.random.RandomState(seed)
    length = N_TILES * TILE_LEN
    start = rng.randint(0, length - 400, 3000)
    end = np.minimum(start + rng.randint(30, 3000, 3000), length)
    count = rng.choice([1, 2, 3, 4, 5, 6, 8, 10], 3000).astype(np.int32)
    es, ee, ec = jmesh.split_events_to_tiles(start, end, count, N_TILES,
                                             TILE_LEN)
    cstart = rng.randint(0, length - 300, 900)
    cend = np.minimum(cstart + 200, length)
    cs, ce, cc = jmesh.split_events_to_tiles(
        cstart, cend, np.ones(900, np.int32), N_TILES, TILE_LEN,
        pad_to=es.shape[1])
    excl = jmesh.split_excl_to_tiles([1000, 1400, 6 * TILE_LEN - 200,
                                      6 * TILE_LEN + 300], N_TILES, TILE_LEN)
    limit = np.array([TILE_LEN] * 7 + [1234], np.int32)
    return ((es, ee, ec, cs, ce, cc, excl, limit),
            ((start, end, count), (cstart, cend, np.ones(900, np.int32))))


def _getval_at(events, pos):
    """The exact engine's getVal of the global class sums at ``pos``."""
    from genrich_tpu.engine import pileup as ep
    start, end, count = events
    diff = np.zeros((N_TILES * TILE_LEN + 1, 4), np.int64)
    for j, (add, sub) in enumerate(((ep._ADD_COV, ep._SUB_COV),
                                    (ep._ADD_E8, ep._SUB_E8),
                                    (ep._ADD_S6, ep._SUB_S6),
                                    (ep._ADD_T10, ep._SUB_T10))):
        np.add.at(diff[:, j], start, add[count])
        np.add.at(diff[:, j], end, sub[count])
    cum = np.cumsum(diff[:-1], axis=0)[pos]
    return ep.canon_value_f32(*cum.T)


def test_cov_step_with_carries_matches_jax():
    args, (expt, ctrl) = _tile_events(5)
    jk = jmesh.ShardedKernels(jmesh.make_mesh(N_TILES), TILE_LEN)
    ref = [np.asarray(x) for x in jk.cov(*(jnp.asarray(a) for a in args))]
    tk = tmesh.ShardedKernels(TILE_LEN)
    t_args = [torch.from_numpy(a) for a in args[:7]]
    got = [x.numpy() for x in tk.cov(*t_args, args[7])]
    carries = tmesh.exclusive_carries(tile_class_totals(*t_args[:3]), None)
    assert bool((carries != 0).any()), "fixture must carry across tiles"
    (s_r, e_r, ev_r, cr_r, ex_r, lv_r, fr_r, cf_r) = ref
    (s, e, ev, cr, ex, lv, fr, cf) = got
    for a, b in ((s, s_r), (e, e_r), (ex, ex_r), (lv, lv_r)):
        np.testing.assert_array_equal(a, b)
    real = e_r > s_r
    assert real.sum() > 1000
    pos = (s + np.arange(N_TILES)[:, None] * TILE_LEN)[real]
    for val, val_r, events in ((ev, ev_r, expt), (cr, cr_r, ctrl)):
        np.testing.assert_array_equal(val[real].view(np.uint32),
                                      _getval_at(events, pos).view(np.uint32))
        np.testing.assert_allclose(val[real], val_r[real], rtol=1e-5)
    assert fr.shape == fr_r.shape == (N_TILES,)
    np.testing.assert_allclose(fr, fr_r, rtol=1e-5)
    np.testing.assert_allclose(cf, cf_r, rtol=1e-5)


def _pvals(seed=31):
    rng = np.random.RandomState(seed)
    n = 20_000
    starts = np.sort(rng.randint(0, 1 << 20, n)).astype(np.int32)
    ends = starts + rng.randint(0, 40, n).astype(np.int32)
    pv = np.round(rng.exponential(3.0, n), 2).astype(np.float32)
    pv[rng.rand(n) < 0.05] = -1.0
    return starts, ends, pv, rng.rand(n) < 0.95


@pytest.mark.parametrize("k", [1 << 13, 64], ids=["fits", "overflow"])
def test_distinct_pvals_k_matches_jax(k):
    args = _pvals()
    pv_r, w_r, d_r = (np.asarray(x) for x in compact_jax.distinct_pvals_k(
        *(jnp.asarray(a) for a in args), k))
    pv, w, d = compact.distinct_pvals_k(*(torch.from_numpy(a)
                                          for a in args), k)
    d = int(d)
    assert d == int(d_r) and d > 64
    n = min(d, k)
    assert pv.shape == w.shape == (k,) and w.dtype == torch.int64
    np.testing.assert_array_equal(pv[:n].numpy(), pv_r[:n])
    np.testing.assert_array_equal(w[:n].numpy(), w_r[:n])
    assert bool(torch.isinf(pv[n:]).all()) and not bool(w[n:].any())


def _straddle_sam(path, centers=(131_072, 400_000, 655_360), seed=3,
                  spanning=0, span_at=524_288):
    """One 1 Mbp chromosome: background pairs, clusters at ``centers``
    (by default one across the tile boundary at 131,072: n_shards=8
    gives 2^17-bp tiles) and multimapped pairs of equal score (weight
    1/2, so the tiles' carries are not zero), drawn from ``seed``; then
    ``spanning`` pairs that each cover 150 bp on both sides of
    ``span_at`` (a tile boundary, and with two ranks the ranks'), so
    the highest interval of that peak crosses it."""
    b = oracle.SamBuilder([("chr1", 1_000_000)], seed=seed)
    rng = b.rng
    for center in centers:
        for _ in range(400):
            p1 = center + rng.randrange(-350, 250)
            b.add_pair("chr1", p1, p1 + rng.randrange(60, 300), score=0)
    for _ in range(1500):
        p1 = rng.randrange(0, 999_000)
        q = b.add_pair("chr1", p1, p1 + rng.randrange(60, 400), score=0)
        if rng.random() < 0.3:
            p2 = rng.randrange(0, 999_000)
            b.add_pair("chr1", p2, p2 + 150, score=0, secondary=True,
                       qname=q)
    for _ in range(spanning):
        b.add_pair("chr1", span_at - rng.randrange(150, 170),
                   span_at + rng.randrange(100, 120), score=0)
    return b.write(path)


def _torch_engine_row_order_aucs(tmp_path, args, monkeypatch):
    """TorchEngine's run of ``args`` with the arguments of its K4 calls
    kept: its lines, and {(start, end): AUC} summed over its own rows in
    row order (``testing.auc_rowwise``, what K4 gives on the card; the
    CPU's plain version sums in float64)."""
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    calls = []
    real = peaks.peak_reduce

    def keep(*a):
        calls.append(a)
        return real(*a)
    monkeypatch.setattr(peaks, "peak_reduce", keep)
    d, _ = _port(tmp_path, args, TorchEngine("cpu"), "torch")
    monkeypatch.setattr(peaks, "peak_reduce", real)
    aucs = {}         # one chromosome: rows are in its coordinates
    for starts, ends, stat, _, _, sig, first, last, min_pq in calls:
        host = [t.numpy() for t in (starts, ends, stat, sig, first, last)]
        ex = host[5] >= host[4]
        auc = testing.auc_rowwise(*host, min_pq)
        for f, la, a in zip(host[4][ex], host[5][ex], auc[ex]):
            aucs[(int(host[0][f]), int(host[1][la]))] = a
    return _lines(d), aucs


def test_peak_straddling_a_tile_boundary_matches_torch_engine(tmp_path,
                                                              monkeypatch):
    """Two merged peaks straddle a tile boundary.  Columns 1-6 equal
    TorchEngine's and the port's exact engine's.  Column 7, as text:
    each straddling peak's is TorchEngine's row-order sum over its own
    rows (K4's on the card), where the sum of the tiles' AUCs was 1-2
    ulp off; the others equal TorchEngine's.  Against the exact engine
    column 7 holds within 1e-6 relative: its float64-exact p-values
    differ from the device's float32 ones in the last digit, so no
    device engine's AUC equals its text."""
    args = ["-t", _straddle_sam(str(tmp_path / "in.sam"))] + BASE
    got_d, perf = _port(tmp_path, args)
    want, row_order = _torch_engine_row_order_aucs(tmp_path, args,
                                                   monkeypatch)
    exact, log = _exact(tmp_path, args)
    got = _lines(got_d)
    assert [a.split("\t")[:6] for a in want] \
        == [b.split("\t")[:6] for b in got] \
        == [c.split("\t")[:6] for c in exact]
    # every summit is the exact engine's (before the rows were merged
    # into its intervals, the peak at 655,014 took a near tie)
    assert check_summits(exact, got, log, 1e-5) == (len(exact), 0)
    assert perf["grid_tile_len"] == 131_072 and perf["grid_tiles"] == 8
    straddling = 0
    for a, b, c in zip(want, got, exact):
        fa, fb, fc = a.split("\t"), b.split("\t"), c.split("\t")
        s, e = int(fb[1]), int(fb[2])
        if s // 131_072 < (e - 1) // 131_072:
            straddling += 1
            assert fb[6] == f"{row_order[(s, e)]:.6f}", (a, b)
        else:
            assert fb[6] == fa[6], (a, b)
        assert abs(float(fb[6]) - float(fc[6])) <= 1e-6 * float(fc[6]), \
            (b, c)
    assert straddling == perf["straddling_peaks"] == 2


def test_row_order_auc_joins_a_row_cut_by_the_tile_boundary():
    """A significant row across the boundary of two tiles is cut in two
    by the grid (the later tile's ``cont``); the sharded engine's
    row-order AUC counts it as one row, bitwise to
    ``testing.auc_rowwise`` over the uncut rows."""
    from genrich_tpu_torch import testing
    rng = np.random.RandomState(7)
    tl, min_pq = 4096, np.float32(2.0)
    cuts = np.unique(np.concatenate([
        [0, 2 * tl], rng.choice(np.arange(1, 2 * tl), 400, replace=False)]))
    cuts = cuts[cuts != tl]                # the boundary cuts one row
    starts, ends = cuts[:-1], cuts[1:]
    stat = rng.uniform(0, 4, len(starts)).astype(np.float32)
    across = int(np.flatnonzero(starts < tl)[-1])
    stat[across - 20:across + 21] = rng.uniform(2.5, 9, 41)
    sig = stat > min_pq
    lo, hi = across, across
    while sig[lo - 1]:
        lo -= 1
    while sig[hi + 1]:
        hi += 1
    want = testing.auc_rowwise(starts, ends, stat, sig, [lo], [hi], min_pq)
    # the fixture's teeth: summing the two halves gives another float32
    halves = testing.auc_rowwise(
        np.insert(starts, across + 1, tl), np.insert(ends, across, tl),
        np.insert(stat, across, stat[across]), np.insert(sig, across, True),
        [lo], [hi + 1], min_pq)
    assert halves[0] != want[0]
    tiles = []
    for t in (0, 1):
        s = np.clip(starts, t * tl, (t + 1) * tl) - t * tl
        e = np.clip(ends, t * tl, (t + 1) * tl) - t * tl
        real = e > s
        tiles.append((s[real], e[real], stat[real]))
    width = max(len(x[0]) for x in tiles)

    def stack(i, fill, dtype):
        return torch.from_numpy(np.stack([np.concatenate(
            [x[i], np.full(width - len(x[i]), fill)]).astype(dtype)
            for x in tiles]))
    st = {"tile_len": tl, "starts": stack(0, tl, np.int32),
          "ends": stack(1, tl, np.int32), "pv": stack(2, 0, np.float32),
          "live": torch.from_numpy(np.stack([np.arange(width) < len(x[0])
                                             for x in tiles])),
          "cont": torch.tensor([False, True])}
    # the engine keeps one tensor a card: this engine has one card
    st = {k: [v] if torch.is_tensor(v) else v for k, v in st.items()}
    eng = ShardedTorchEngine("cpu", n_shards=2)
    got = eng._row_order_peaks(st, np.array([starts[lo]]),
                               np.array([ends[hi]]), min_pq, False)[0]
    assert hi - lo > 30 and want[0] > 0
    assert got.view(np.uint32)[0] == want.view(np.uint32)[0], (got, want)

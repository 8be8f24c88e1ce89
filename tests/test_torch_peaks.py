"""The gap-join (kernel K5's design) and the per-peak reduction (plain
version of kernel K4) against the references.

``testing.gap_join_blocked``, a numpy transcription of K5's design
(persistent blocks taking tiles from a counter through a ring, each
thread's fold, the packed State's combine, the block-wide look-back,
the candidate writes and the last block's K slots), equals the plain
``peak_candidates`` bitwise for tiles of 1, 7, 32, 1,024 and 4,096
rows, with as many blocks as the H100 runs at once and with fewer
blocks than tiles, on rows with SKIP rows, dead rows, zero-length rows,
gaps of exactly max_gap and more candidates than K; the plain version
holds to ``peaks_jax.call_peaks`` (the candidates' starts, ends and
count).

``ops/peaks.call_peaks`` takes each peak's AUC as a difference of
float64 prefix sums rounded to float32, and its summit by segmented
arg-maxima; kernel K4 walks the rows in order instead (compared with
this plain version on the card in test_torch_kernels.py).  Here, on the
CPU: on a long chromosome the plain AUC is within rtol 1e-6 of the
exact engine's sequential float32 sum (``engine/peaks.call_peaks_chrom``,
Genrich.c:948-1069), where a float32 prefix-sum difference is not; the
summit columns are equal; and summits above 2^30 bp take their midpoint
in 64 bits, as the exact engine does.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401  (pins jax to the CPU before import)
import jax.numpy as jnp
import torch

from genrich_tpu.engine import peaks as epeaks
from genrich_tpu.ops import peaks_jax
from genrich_tpu_torch import kernels
from genrich_tpu_torch.ops import peaks
from genrich_tpu_torch.testing import (auc_rowwise, gap_join_blocked,
                                       gap_join_rows, peak_rows)

F32 = np.float32


def _port_peaks(ends, stat, pval, qval, min_pq, min_auc, min_len,
                max_gap):
    starts = np.concatenate([[0], ends[:-1]])
    t = [torch.from_numpy(a) for a in (starts.astype(np.int32),
                                       ends.astype(np.int32), stat, pval,
                                       qval)]
    res = peaks.call_peaks(*t, torch.ones(len(ends), dtype=torch.bool),
                           min_pq, min_auc, min_len, max_gap,
                           k_peaks=len(ends))
    k = np.flatnonzero(res.valid.numpy())
    return {f: getattr(res, f).numpy()[k]
            for f in ("start", "end", "auc", "summit_pval", "summit_qval",
                      "summit_pos")}


def _exact_peaks(ends, stat, pval, qval, min_pq, min_auc, min_len,
                 max_gap):
    pk = epeaks.call_peaks_chrom(stat, pval, qval, ends, F32(min_pq),
                                 F32(min_auc), min_len, max_gap)
    return {f: np.array([getattr(p, f) for p in pk])
            for f in ("start", "end", "auc", "summit_pval", "summit_qval",
                      "summit_pos")}


def test_auc_long_chromosome_matches_exact_sequential_sum():
    rng = np.random.RandomState(5)
    args = peak_rows(rng, 400_000, 3000)
    params = (2.0, 20.0, 0, 100)
    got = _port_peaks(*args, *params)
    want = _exact_peaks(*args, *params)
    assert len(want["start"]) > 2000
    for f in ("start", "end", "summit_pval", "summit_qval", "summit_pos"):
        np.testing.assert_array_equal(got[f], want[f], f)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-6)
    # the float32 prefix-sum difference (the JAX twin's AUC) is not
    # within that tolerance on this chromosome
    ends, stat = args[0], args[1]
    lens = np.diff(np.concatenate([[0], ends])).astype(F32)
    contrib = np.where(stat > F32(2.0), lens * (stat - F32(2.0)),
                       F32(0.0)).astype(F32)
    csum = np.cumsum(contrib, dtype=F32)
    k = np.searchsorted(ends, want["end"])
    first = np.searchsorted(ends, want["start"], side="right")
    f32_auc = csum[k] - np.where(first > 0, csum[first - 1], F32(0.0))
    assert np.max(np.abs(f32_auc - want["auc"]) / want["auc"]) > 1e-5


def test_auc_rowwise_is_the_exact_engines_sum():
    """``testing.auc_rowwise``, the reference that K4's AUC is held to
    bit for bit on the card, equals the exact engine's AUC bitwise on
    peaks of hundreds of rows; the plain version's float64 prefix
    difference does not, so that check sees the order of the sum."""
    rng = np.random.RandomState(6)
    ends, stat, pval, qval = peak_rows(rng, 60_000, 40,
                                       region_rows=(200, 1000),
                                       skip_frac=0.0)
    starts = np.concatenate([[0], ends[:-1]])
    t = [torch.from_numpy(a) for a in (starts.astype(np.int32),
                                       ends.astype(np.int32), stat, pval,
                                       qval)]
    c = peaks.peak_candidates(t[0], t[1], t[2],
                              torch.ones(len(ends), dtype=torch.bool),
                              2.0, 100, len(ends))
    ex = c.exists.numpy()
    first, last = c.first.numpy()[ex], c.last.numpy()[ex]
    got = auc_rowwise(starts, ends, stat, c.sig.numpy(), first, last, 2.0)
    want = _exact_peaks(ends, stat, pval, qval, 2.0, 0.0, 0, 100)["auc"]
    assert len(want) > 30 and np.median(last - first) > 100
    np.testing.assert_array_equal(got, want)
    plain = peaks.peak_reduce_plain(*t, c.sig, c.first, c.last,
                                    2.0)[0].numpy()[ex]
    # float32 rounding drifts over hundreds of adds: rtol 1e-5, as K4
    # against the plain version on the card
    np.testing.assert_allclose(plain, want, rtol=1e-5)
    assert np.any(plain != want)


def test_summit_midpoint_past_2_30_bp():
    """Intervals above 2^30 bp: start + end exceeds int32, the summit
    (narrowPeak column 10) still equals the exact engine's.  The JAX
    twin sums start + end in int32 (peaks_jax.py:125), which wraps
    there, so ``--engine jax`` differs in this column."""
    base = 1_500_000_000
    ends = np.array([base, base + 100, base + 250, base + 300,
                     base + 700, base + 760, 2_000_000_000], np.int64)
    stat = np.array([0, 5, 9, 3, 9, 0.5, 0], F32)
    pval = stat + F32(1)
    qval = stat * F32(0.5)
    params = (2.0, 0.0, 0, 100)
    got = _port_peaks(ends, stat, pval, qval, *params)
    want = _exact_peaks(ends, stat, pval, qval, *params)
    assert len(want["start"]) == 1
    for f in ("start", "end", "summit_pos", "summit_pval"):
        np.testing.assert_array_equal(got[f], want[f], f)
    # the longest max-stat row (base+300..base+700) holds the summit
    assert want["summit_pos"][0] == (2 * base + 1000) // 2 - (base)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    jx = peaks_jax.call_peaks(
        jnp.asarray(starts), jnp.asarray(ends.astype(np.int32)),
        jnp.asarray(stat), jnp.asarray(pval), jnp.asarray(qval),
        jnp.ones(len(ends), bool), jnp.float32(2.0), jnp.float32(0.0),
        0, 100, k_peaks=len(ends))
    k = np.flatnonzero(np.asarray(jx.valid))
    assert np.asarray(jx.summit_pos)[k][0] != want["summit_pos"][0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_peak_reduce_plain_matches_sequential_walk(seed):
    """Every candidate, summit fields exact, AUC rtol 1e-6, against a
    direct Python walk of updatePeak over the same rows."""
    rng = np.random.RandomState(seed)
    ends, stat, pval, qval = peak_rows(rng, 20_000, 150)
    starts = np.concatenate([[0], ends[:-1]])
    t = {k: torch.from_numpy(v) for k, v in (
        ("s", starts.astype(np.int32)), ("e", ends.astype(np.int32)),
        ("st", stat), ("p", pval), ("q", qval))}
    res = peaks.call_peaks(t["s"], t["e"], t["st"], t["p"], t["q"],
                           torch.ones(len(ends), dtype=torch.bool),
                           2.0, 0.0, 0, 100, k_peaks=len(ends))
    cand = np.flatnonzero(res.cand.numpy())
    assert len(cand) > 100
    sig = stat > F32(2.0)
    for j in cand[::7]:
        lo = np.searchsorted(starts, int(res.start[j]))
        hi = np.searchsorted(ends, int(res.end[j]))
        auc, best, blen, pos, pq = F32(0), F32(-np.inf), 0, lo, lo
        for i in range(lo, hi + 1):
            if not sig[i]:
                continue
            ln = int(ends[i] - starts[i])
            auc = F32(auc + F32(ln) * F32(stat[i] - F32(2.0)))
            if stat[i] > best:
                best, blen, pos, pq = stat[i], ln, i, i
            elif stat[i] == best and ln > blen:
                blen, pos = ln, i
        assert float(res.summit_stat[j]) == best
        assert int(res.summit_len[j]) == blen
        assert float(res.summit_pval[j]) == pval[pq]
        assert float(res.summit_qval[j]) == qval[pq]
        assert int(res.summit_pos[j]) == (starts[pos] + ends[pos]) // 2 \
            - starts[lo]
        assert abs(float(res.auc[j]) - auc) <= 1e-6 * abs(auc)


def test_peak_reduce_cpu_runs_plain_and_checks_types():
    kernels.reset_launches()
    rng = np.random.RandomState(4)
    ends, stat, pval, qval = peak_rows(rng, 2000, 10)
    _port_peaks(ends, stat, pval, qval, 2.0, 0.0, 0, 100)
    assert kernels.LAUNCHES["peak_reduce"] == 0
    i32 = torch.zeros(4, dtype=torch.int32)
    f32 = torch.zeros(4)
    i64 = torch.zeros(2, dtype=torch.int64)
    b = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        peaks.peak_reduce(i32, i32, f32.double(), f32, f32, b, i64, i64,
                          1.0)
    with pytest.raises(TypeError):
        peaks.peak_reduce(i32, i32, f32, f32, f32, b, i64.int(), i64, 1.0)


# (seed, rows, max_gap, peak regions, k_peaks, dead tail rows)
GAP_JOIN_CASES = [(1, 3000, 10, 150, 4096, 0), (2, 2500, 100, 200, 17, 0),
                  (3, 2047, 0, 120, 64, 300), (4, 1, 10, 1, 4096, 0),
                  (5, 600, 50, 0, 8, 0)]


def _gap_join_plain(case):
    seed, m, gap, regions, k, tail = case
    rows = gap_join_rows(np.random.RandomState(seed), m, gap, regions,
                         dead_tail=tail)
    got = peaks.peak_candidates(*(torch.from_numpy(a) for a in rows), 2.0,
                                gap, k)
    return rows, got


# the persistent blocks that gap_join_blocked runs each tile size with:
# 264 is the H100's grid (two blocks on each of 132 SMs); the others give
# more tiles than blocks, so blocks take tile after tile
BLOCKS = {1: [4, 2], 7: [3, 264], 32: [8, 264], 1024: [264, 1],
          4096: [264, 2]}


@pytest.mark.parametrize("tile", [1, 7, 32, 1024, 4096])
@pytest.mark.parametrize("case", GAP_JOIN_CASES)
def test_gap_join_blocked_matches_plain(case, tile):
    """K5's design, transcribed, gives the plain version's bits: the sig
    and skp rows, first/last/exists of every slot (empty ones (0, -1))
    and the count, also where the count exceeds K; for 4,096-row tiles
    (K5's) on one tile, for tiles of 1-1,024 rows on many, with a ragged
    last tile, and with more tiles than persistent blocks, each block
    taking tile after tile through its ring."""
    seed, m, gap, regions, k, tail = case
    rows, want = _gap_join_plain(case)
    for i, blocks in enumerate(BLOCKS[tile]):
        got = gap_join_blocked(*rows, 2.0, gap, k, tile, blocks, seed=i)
        for name, g, w in zip(("sig", "skp", "first", "last", "exists",
                               "n"), got, want):
            np.testing.assert_array_equal(np.asarray(g), w.numpy(),
                                          f"{name}, {blocks} blocks")
    assert want.first.dtype == want.last.dtype == torch.int64
    n, k_eff = int(want.n), min(k, m)
    assert int(want.exists.sum()) == min(n, k_eff)
    if seed == 2:
        assert n > k_eff                      # the cap drops candidates
    if regions > 50:
        assert n > 20 and bool(want.skp.any())


@pytest.mark.parametrize("case", GAP_JOIN_CASES[:3])
def test_gap_join_plain_matches_jax(case):
    """The plain gap-join against ``peaks_jax.call_peaks``: each slot's
    start (row first) and end (row last), the slots that are
    candidates, and the count."""
    seed, m, gap, regions, k, tail = case
    (s, e, st, lv), got = _gap_join_plain(case)
    ref = peaks_jax.call_peaks(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(st), jnp.asarray(st),
        jnp.asarray(st), jnp.asarray(lv), jnp.float32(2.0),
        jnp.float32(0.0), 0, gap, k_peaks=k)
    ex = got.exists.numpy()
    np.testing.assert_array_equal(ex, np.asarray(ref.cand))
    np.testing.assert_array_equal(s[got.first.numpy()][ex],
                                  np.asarray(ref.start)[ex])
    np.testing.assert_array_equal(e[got.last.numpy()][ex],
                                  np.asarray(ref.end)[ex])
    assert int(got.n) == int(ref.n_peaks) > 20


def test_gap_join_breaks_and_joins():
    """One bp over max_gap breaks and a gap of exactly max_gap joins; a
    live SKIP row between two significant rows breaks although they are
    4 bp apart; a zero-length SKIP row and a dead row above the
    threshold in between do not."""
    starts = np.array([0, 21, 31, 31, 51, 61, 70, 72, 74, 95, 97], np.int32)
    ends = np.array([10, 31, 31, 41, 61, 70, 72, 74, 95, 97, 99], np.int32)
    stat = np.array([5, 5, -1, 5, 5, 5, -1, 0, 5, 5, 5], np.float32)
    live = np.ones(11, bool)
    live[9] = False
    got = peaks.peak_candidates(*(torch.from_numpy(a) for a in
                                  (starts, ends, stat, live)), 2.0, 10, 8)
    ex = got.exists.numpy()
    assert int(got.n) == 3 and ex.tolist() == [False] * 5 + [True] * 3
    np.testing.assert_array_equal(got.first.numpy(), [0] * 5 + [0, 1, 8])
    np.testing.assert_array_equal(got.last.numpy(), [-1] * 5 + [0, 5, 10])
    for tile in (1, 2, 3):
        blk = gap_join_blocked(starts, ends, stat, live, 2.0, 10, 8, tile)
        np.testing.assert_array_equal(blk[2], got.first.numpy())
        np.testing.assert_array_equal(blk[3], got.last.numpy())

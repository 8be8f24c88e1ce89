"""Pipeline stages of the port against their JAX twins, on the CPU.

tile_coverage (ctrl, exclusions, limit), tile_stats, distinct_pvals,
assign_qvals and call_peaks each take the same numpy inputs as the JAX
stage, and each stage after the first is fed the JAX stage's output,
so errors do not compound.  Tolerances: integers and masks bitwise on
rows of length > 0 (the event sorts are unstable, so rows that share a
position may permute); fragment sums rel 1e-6 (float32 sums in another
order); floats rtol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401
import jax.numpy as jnp
import torch

from genrich_tpu.engine.qvalue import merge_distinct_tables
from genrich_tpu.ops import compact_jax, peaks_jax, pipeline_jax
from genrich_tpu_torch import kernels
from genrich_tpu_torch.ops import compact, peaks, pipeline


def T(a):
    """numpy (or a read-only view of a JAX array) -> CPU tensor."""
    return torch.from_numpy(np.array(a))


def _events(rng, n, length, n_pad, hot=True):
    centers = rng.randint(500, length - 1500, 6)
    base = np.where(rng.rand(n) < (0.7 if hot else 0.0),
                    centers[rng.randint(0, 6, n)]
                    + rng.randint(0, 800, n),
                    rng.randint(0, length - 500, n))
    start = np.clip(base, 0, length - 2).astype(np.int32)
    end = np.minimum(start + rng.randint(30, 400, n), length) \
        .astype(np.int32)
    count = rng.choice([1, 1, 1, 2, 3, 4, 5, 6, 8, 10], n).astype(np.int32)
    # padding rows: count 0 at tile_len (the JAX engine's bucket fill)
    pad = np.full(n_pad, length, np.int32)
    return (np.concatenate([start, pad]), np.concatenate([end, pad]),
            np.concatenate([count, np.zeros(n_pad, np.int32)]))


def _case(seed, with_ctrl=True, excl_pairs=((4000, 9000),
                                            (30000, 30500))):
    rng = np.random.RandomState(seed)
    length = 60_000
    es, ee, ec = _events(rng, 1500, length, 37)
    if with_ctrl:
        cs, ce, cc = _events(rng, 700, length, 11, hot=False)
    else:
        cs = ce = np.full(5, length, np.int32)
        cc = np.zeros(5, np.int32)
    excl = np.full((4, 2), length, np.int32)
    for i, pr in enumerate(excl_pairs):
        excl[i] = pr
    return es, ee, ec, cs, ce, cc, excl, length


def _jax_coverage(case, limit=None):
    es, ee, ec, cs, ce, cc, excl, length = case
    z4 = jnp.zeros(4, jnp.int32)
    out = pipeline_jax.tile_coverage(
        *(jnp.asarray(a) for a in (es, ee, ec, cs, ce, cc, excl)),
        jnp.int32(length), z4, z4,
        None if limit is None else jnp.int32(limit))
    return [np.asarray(x) for x in out]


def _torch_coverage(case, limit=None, count_dtype=np.uint8):
    es, ee, ec, cs, ce, cc, excl, length = case
    z4 = torch.zeros(4, dtype=torch.int32)
    out = pipeline.tile_coverage(
        T(es), T(ee), T(ec.astype(count_dtype)), T(cs), T(ce),
        T(cc.astype(count_dtype)), T(excl), length, z4, z4, limit)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("kind", ["ctrl_excl", "no_ctrl", "limit",
                                  "no_excl"])
def test_tile_coverage_matches_jax(kind):
    case = _case(11, with_ctrl=(kind != "no_ctrl"),
                 excl_pairs=(() if kind == "no_excl"
                             else ((4000, 9000), (30000, 30500))))
    limit = 41_234 if kind == "limit" else None
    ref = _jax_coverage(case, limit)
    got = _torch_coverage(case, limit)
    (s_r, e_r, ev_r, cr_r, ex_r, lv_r, fr_r, cf_r) = ref
    (s, e, ev, cr, ex, lv, fr, cf) = got
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(e, e_r)
    np.testing.assert_array_equal(ex, ex_r)
    np.testing.assert_array_equal(lv, lv_r)
    real = e_r > s_r
    assert real.sum() > 1000
    np.testing.assert_array_equal(ev[real].view(np.uint32),
                                  ev_r[real].view(np.uint32))
    np.testing.assert_array_equal(cr[real].view(np.uint32),
                                  cr_r[real].view(np.uint32))
    assert abs(float(fr) - float(fr_r)) <= 1e-6 * abs(float(fr_r))
    assert abs(float(cf) - float(cf_r)) <= 1e-6 * max(abs(float(cf_r)),
                                                        1.0)


def test_tile_coverage_int64_count_codes():
    """Count codes of any integer dtype index the class tables."""
    case = _case(12)
    a = _torch_coverage(case, count_dtype=np.uint8)
    b = _torch_coverage(case, count_dtype=np.int64)
    real = a[1] > a[0]
    np.testing.assert_array_equal(a[2][real], b[2][real])
    np.testing.assert_array_equal(a[3][real], b[3][real])


def test_tile_coverage_cpu_runs_plain_scan():
    kernels.reset_launches()
    _torch_coverage(_case(13))
    assert kernels.LAUNCHES["coverage_scan"] == 0
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_excluded_matches_searchsorted_parity():
    rng = np.random.RandomState(3)
    bounds = np.sort(rng.choice(1 << 20, 2 * 40,
                                replace=False)).astype(np.int32)
    starts = rng.randint(0, 1 << 20, 4096).astype(np.int32)
    starts[:80] = bounds       # boundary-inclusive semantics
    want = np.asarray(pipeline_jax._excluded(jnp.asarray(starts),
                                             jnp.asarray(bounds
                                                         .reshape(-1, 2))))
    got = pipeline._excluded(T(starts), T(bounds.reshape(-1, 2))).numpy()
    np.testing.assert_array_equal(got, want)


def _stats_inputs(seed=21):
    ref = _jax_coverage(_case(seed))
    return ref, 1.37, 0.61


def test_tile_stats_matches_jax():
    (s, e, ev, cr, ex, lv, fr, cf), factor, lam = _stats_inputs()
    pv_r = np.asarray(pipeline_jax.tile_stats(
        jnp.asarray(ev), jnp.asarray(cr), jnp.asarray(ex),
        jnp.float32(factor), jnp.float32(lam)))
    pv = pipeline.tile_stats(T(ev), T(cr), T(ex), factor, lam).numpy()
    assert (pv_r == -1.0).any() and (pv_r > 2.0).any()
    np.testing.assert_allclose(pv, pv_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pv == -1.0, pv_r == -1.0)


def test_tile_stats_rejects_mixed_dtypes():
    f = torch.zeros(8)
    with pytest.raises(TypeError):
        pipeline.tile_stats(f, f.double(), torch.zeros(8, dtype=torch.bool),
                            1.0, 1.0)


def _jax_pvals(seed=31):
    (s, e, ev, cr, ex, lv, fr, cf), factor, lam = _stats_inputs(seed)
    pv = np.asarray(pipeline_jax.tile_stats(
        jnp.asarray(ev), jnp.asarray(cr), jnp.asarray(ex),
        jnp.float32(factor), jnp.float32(lam)))
    return s, e, pv, lv


def test_distinct_pvals_matches_jax():
    s, e, pv, lv = _jax_pvals()
    pd_r, wd_r, d_r = (np.asarray(x) for x in compact_jax.distinct_pvals(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(pv), jnp.asarray(lv)))
    pd, wd, d = compact.distinct_pvals(T(s), T(e), T(pv), T(lv))
    d = int(d)
    assert d == int(d_r) and d > 10
    np.testing.assert_array_equal(pd[:d].numpy(), pd_r[:d])
    np.testing.assert_array_equal(wd[:d].numpy(), wd_r[:d])
    assert wd.dtype == torch.int32


def _distinct_cummax(starts, ends, pv, live, dtype):
    """The cummax form of ``compact._distinct_runs`` before it was
    rewritten (each run's bp from the running maximum of the run ends'
    cumulative bp), then compacted as distinct_pvals did."""
    lens = ends - starts
    real = live & (lens > 0) & (pv != -1.0)
    key = torch.where(real, pv, torch.full_like(pv, float("inf")))
    w = torch.where(real, lens, torch.zeros_like(lens)).to(torch.int64)
    key_s, order = torch.sort(key)
    cum = torch.cumsum(w[order], dim=0)
    is_last = torch.cat([key_s[1:] != key_s[:-1],
                         torch.ones(1, dtype=torch.bool)])
    run_end = torch.cummax(torch.where(is_last, cum, torch.zeros_like(cum)),
                           dim=0).values
    prev = torch.cat([torch.zeros(1, dtype=cum.dtype), run_end[:-1]])
    (pv_d, w_d), d = compact.compact(is_last & torch.isfinite(key_s),
                                     (key_s, (cum - prev).to(dtype)))
    return pv_d, w_d, d


@pytest.mark.parametrize("seed,k", [(31, 1 << 13), (32, 64), (33, 1 << 15)])
def test_distinct_runs_without_cummax_is_bitwise(seed, k):
    """distinct_pvals and distinct_pvals_k are bitwise what the cummax
    form gave: the table rows, the count and (for the [k] table, an
    overflowing one included) every padding row."""
    s, e, pv, lv = (T(a) for a in _jax_pvals(seed))
    pv = pv.clone()
    pv[::97] = -1.0                      # SKIP rows carry no weight
    for dtype in (torch.int32, torch.int64):
        want = _distinct_cummax(s, e, pv, lv, dtype)
        d = int(want[2])
        got = (compact.distinct_pvals(s, e, pv, lv) if dtype == torch.int32
               else compact.distinct_pvals_k(s, e, pv, lv, max(d, 1)))
        assert int(got[2]) == d > 10
        assert torch.equal(got[0][:d], want[0][:d])
        assert torch.equal(got[1][:d], want[1][:d])
        assert got[1].dtype == dtype
    pk, wk, dk = compact.distinct_pvals_k(s, e, pv, lv, k)
    n = min(k, d)
    assert int(dk) == d
    assert torch.equal(pk[:n], want[0][:n]) and torch.equal(wk[:n],
                                                            want[1][:n])
    assert bool(torch.isinf(pk[n:]).all()) and not bool(wk[n:].any())


def test_assign_qvals_matches_jax():
    s, e, pv, lv = _jax_pvals()
    pd_r, wd_r, d_r = (np.asarray(x) for x in compact_jax.distinct_pvals(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(pv), jnp.asarray(lv)))
    d = int(d_r)
    _, _, tab_p, tab_q, _, _ = merge_distinct_tables(
        [pd_r[:d]], [wd_r[:d].astype(np.uint64)], 60_000)
    q_r = np.asarray(compact_jax.assign_qvals(
        jnp.asarray(pv), jnp.asarray(tab_p), jnp.asarray(tab_q)))
    q = compact.assign_qvals(T(pv), T(tab_p), T(tab_q)).numpy()
    np.testing.assert_array_equal(q, q_r)


def test_rle_pv_matches_jax():
    s, e, pv, lv = _jax_pvals()
    r = [np.asarray(x) for x in compact_jax.rle_pv(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(pv), jnp.asarray(lv),
        jnp.int32(60_000))]
    g = [x.numpy() for x in compact.rle_pv(T(s), T(e), T(pv), T(lv),
                                           60_000)]
    b = int(r[2])
    assert int(g[2]) == b and b > 10
    np.testing.assert_array_equal(g[0], r[0])   # padding is defined too
    np.testing.assert_array_equal(g[1], r[1])


def test_compact_preserves_order():
    mask = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.bool)
    (a,), n = compact.compact(mask, (torch.arange(6) * 10,))
    assert int(n) == 3 and a[:3].tolist() == [10, 20, 40]


PEAK_FIELDS_EXACT = ("start", "end", "summit_pos", "summit_pval",
                     "summit_qval", "summit_stat", "summit_len")


def _compare_peaks(ref, got):
    """``got`` against the JAX peaks ``ref``: the exact fields bitwise,
    AUC within 1e-5 relative."""
    ex = np.asarray(ref.cand)
    np.testing.assert_array_equal(got.cand.numpy(), ex)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for f in PEAK_FIELDS_EXACT:
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[ex], np.asarray(getattr(ref, f))[ex],
            err_msg=f)
    np.testing.assert_allclose(got.auc.numpy()[ex], np.asarray(ref.auc)[ex],
                               rtol=1e-5)
    for f in ("skip_head", "skip_tail", "n_peaks"):
        assert int(getattr(got, f)) == int(np.asarray(getattr(ref, f))), f
    return int(ex.sum())


@pytest.mark.parametrize("use_q", [False, True])
def test_call_peaks_matches_jax(use_q):
    s, e, pv, lv = _jax_pvals()
    if use_q:
        pd, wd, d = compact_jax.distinct_pvals(
            jnp.asarray(s), jnp.asarray(e), jnp.asarray(pv),
            jnp.asarray(lv))
        d = int(d)
        _, _, tab_p, tab_q, _, _ = merge_distinct_tables(
            [np.asarray(pd)[:d]], [np.asarray(wd)[:d].astype(np.uint64)],
            60_000)
        qv = np.asarray(compact_jax.assign_qvals(
            jnp.asarray(pv), jnp.asarray(tab_p), jnp.asarray(tab_q)))
        stat, min_pq = qv, 0.7
    else:
        qv = np.full_like(pv, -1.0)
        stat, min_pq = pv, 2.0
    args = (s, e, stat, pv, qv, lv)
    ref = peaks_jax.call_peaks(*(jnp.asarray(a) for a in args),
                               jnp.float32(min_pq), jnp.float32(20.0),
                               30, 100, k_peaks=512)
    got = peaks.call_peaks(*(T(a) for a in args), min_pq, 20.0, 30, 100,
                           k_peaks=512)
    assert _compare_peaks(ref, got) >= 3


def test_call_peaks_summit_tie_rules():
    """Position: max stat, then longest, then earliest; summit p/q from
    the first max-stat row (Genrich.c:948-964)."""
    starts = np.array([0, 10, 20, 35, 40, 60, 70, 80], np.int32)
    ends = np.array([10, 20, 35, 40, 60, 70, 80, 95], np.int32)
    stat = np.array([1, 5, 5, 3, 5, 9, 9, 9], np.float32)
    pval = np.arange(8, dtype=np.float32) + 100
    qval = np.arange(8, dtype=np.float32) + 200
    live = np.ones(8, bool)
    args = (starts, ends, stat, pval, qval, live)
    ref = peaks_jax.call_peaks(*(jnp.asarray(a) for a in args),
                               jnp.float32(2.0), jnp.float32(0.0), 0, 100,
                               k_peaks=8)
    got = peaks.call_peaks(*(T(a) for a in args), 2.0, 0.0, 0, 100,
                           k_peaks=8)
    assert _compare_peaks(ref, got) == 1
    k = int(np.flatnonzero(got.cand.numpy())[0])
    # stat 9 on rows 5..7: the longest (row 7, 15 bp) holds the summit
    # position; p/q come from the first max-stat row (row 5)
    assert int(got.summit_pos[k]) == (80 + 95) // 2 - 10
    assert float(got.summit_pval[k]) == 105.0
    assert float(got.summit_qval[k]) == 205.0


def test_call_peaks_skip_breaks_and_empty():
    starts = np.array([0, 10, 20, 30, 40], np.int32)
    ends = np.array([10, 20, 30, 40, 50], np.int32)
    stat = np.array([5, 5, -1, 5, 0], np.float32)
    args = (starts, ends, stat, stat, np.full(5, -1, np.float32),
            np.ones(5, bool))
    ref = peaks_jax.call_peaks(*(jnp.asarray(a) for a in args),
                               jnp.float32(1.0), jnp.float32(0.0), 0, 100,
                               k_peaks=4)
    got = peaks.call_peaks(*(T(a) for a in args), 1.0, 0.0, 0, 100,
                           k_peaks=4)
    assert _compare_peaks(ref, got) == 2
    none = peaks.call_peaks(*(T(a) for a in args), 10.0, 0.0, 0, 100,
                            k_peaks=4)
    assert int(none.n_peaks) == 0 and not none.cand.any()


# --- the tile helpers (pipeline_jax.py:44-90, 176-209) ----------------------

def _tile(seed, n=2500, length=1 << 15, weights=(1, 1, 1, 2, 5)):
    rng = np.random.RandomState(seed)
    start = np.concatenate([rng.randint(0, length - 300, n // 2),
                            rng.randint(9000, 11000, n - n // 2)])
    end = np.minimum(start + rng.randint(80, 300, n), length)
    count = rng.choice(weights, n).astype(np.int32)
    pad = np.full(7, length, np.int32)         # padding rows, count 0
    return (np.concatenate([start, pad]).astype(np.int32),
            np.concatenate([end, pad]).astype(np.int32),
            np.concatenate([count, np.zeros(7, np.int32)]), length)


def test_tile_class_totals_matches_jax():
    s, e, c, _ = _tile(41)
    want = np.asarray(pipeline_jax.tile_class_totals(*(jnp.asarray(a)
                                                       for a in (s, e, c))))
    got = pipeline.tile_class_totals(T(s), T(e), T(c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and bool((got != 0).any())
    batch = pipeline.tile_class_totals(*(T(np.stack([a, a])) for a in
                                         (s, e, c)))
    np.testing.assert_array_equal(batch.numpy(), np.stack([want, want]))

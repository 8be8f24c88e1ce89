"""Fisher slice of the port against its JAX twins, on the CPU.

``ops/chisq.py`` (the pgamma family and ``fisher_combine_plain``, the
plain version of kernel K3) and ``ops/compact.py``'s ``merge_fisher``
and ``rle_runs`` take the same numpy inputs, made from a seed, as
``ops/chisq_jax.py``, ``ops/compact_jax.py`` and the exact engine's
``engine/chisq.py``.  Tolerances: float64 against the exact engine rtol
1e-12 (the same libm, another order of a few operations); float32
against chisq_jax rtol = atol = 1e-5; merged breakpoints and live masks
bitwise, combined values 1e-4 relative (the JAX twin combines in
float32, the port in float64); RLE ends bitwise, values 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401  (pins jax to the CPU before import)
import jax
import jax.numpy as jnp
import torch

from genrich_tpu.engine import chisq as echisq
from genrich_tpu.engine.pileup import Pileup
from genrich_tpu.ops import chisq_jax, compact_jax, pipeline_jax
from genrich_tpu_torch import kernels
from genrich_tpu_torch.ops import chisq, compact

F32 = np.float32


def T(a):
    return torch.from_numpy(np.array(a))


class x64:
    """jax float64 for the duration of a block (test_chisq_jax's way)."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


# --- the pgamma family ---------------------------------------------------

@pytest.mark.parametrize("df", [4, 6, 8, 40, 200, 400])
def test_pchisq_f64_matches_exact(df):
    rng = np.random.RandomState(df)
    xs = np.concatenate([rng.uniform(0.01, 2.0, 32),       # x/2 < 1
                         rng.uniform(0.01, 4 * df, 64)])
    want = echisq.pchisq_neglog10(xs, np.full(len(xs), df))
    got = chisq.pchisq_neglog10(T(xs), df).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("df", [4, 20, 100])
def test_pchisq_f32_matches_jax(df):
    rng = np.random.RandomState(10 + df)
    xs = rng.uniform(0.1, 3 * df, 256).astype(F32)
    want = np.asarray(chisq_jax.pchisq_neglog10(jnp.asarray(xs), df))
    got = chisq.pchisq_neglog10(T(xs), df).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _series_inputs(name, dtype):
    rng = np.random.RandomState(7)
    n = 300
    if name == "bd0":
        x = rng.uniform(1.0, 150.0, n)
        lam = np.where(rng.rand(n) < 0.6, x * rng.uniform(0.9, 1.1, n),
                       rng.uniform(1.0, 300.0, n))
        args = (x, lam)
    elif name == "stirlerr":
        args = (rng.randint(1, 200, n).astype(np.float64),)
    elif name == "dpois":
        x = rng.randint(1, 200, n).astype(np.float64)
        args = (x, x * rng.uniform(0.5, 1.5, n))
    elif name == "pd_upper_series":
        alph = rng.randint(2, 200, n).astype(np.float64)
        args = (alph * rng.uniform(0.01, 1.0, n), alph)
    elif name == "pd_lower_series":
        y = rng.randint(1, 199, n).astype(np.float64)
        args = (y * rng.uniform(1.0, 3.0, n), y)
    elif name == "pgamma_smallx":
        # alph up to 20: beyond, log(1 - P) of x < 1 is subnormal
        args = (rng.uniform(0.001, 0.999, n),
                rng.randint(2, 21, n).astype(np.float64))
    else:      # pgamma: all three branches
        alph = rng.randint(2, 200, n).astype(np.float64)
        args = (np.concatenate([rng.uniform(0.01, 1.0, n // 3),
                                rng.uniform(1.0, 1.0 * alph[:n // 3]),
                                rng.uniform(alph[:n - 2 * (n // 3)],
                                            4.0 * alph[:n - 2 * (n // 3)])]),
                alph)
    return tuple(a.astype(dtype) for a in args)


SERIES = ["bd0", "stirlerr", "dpois", "pd_upper_series",
          "pd_lower_series", "pgamma_smallx", "pgamma"]
_EXACT = {"bd0": echisq._bd0, "stirlerr": echisq._stirlerr,
          "dpois": echisq._dpois, "pd_upper_series": echisq._pd_upper_series,
          "pd_lower_series": echisq._pd_lower_series,
          "pgamma_smallx": echisq.pgamma_smallx, "pgamma": echisq.pgamma}


def _port(name):
    return getattr(chisq, name if name == "pgamma" else "_" + name)


def _jax(name):
    return getattr(chisq_jax, name if name == "pgamma" else "_" + name)


@pytest.mark.parametrize("name", SERIES)
def test_series_f64_matches_exact(name):
    args = _series_inputs(name, np.float64)
    want = _EXACT[name](*args)
    got = _port(name)(*(T(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", SERIES)
def test_series_f32_matches_jax(name):
    args = _series_inputs(name, np.float32)
    want = np.asarray(_jax(name)(*(jnp.asarray(a) for a in args)))
    got = _port(name)(*(T(a) for a in args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- fisher_combine ------------------------------------------------------

def _fisher_case(r=3, m=200, seed=2):
    """test_chisq_jax.py::test_fisher_combine_matches_engine's case."""
    rng = np.random.RandomState(seed)
    pv = rng.uniform(0, 8, (r, m)).astype(F32)
    pv[0, :40] = -1.0          # SKIP lanes
    pv[:, 50:60] = -1.0        # fully-skipped intervals
    return pv


def test_fisher_combine_plain_matches_jax():
    pv = _fisher_case()
    with x64():
        want = np.asarray(chisq_jax.fisher_combine(
            jnp.asarray(pv.astype(np.float64)))).astype(F32)
    got = chisq.fisher_combine_plain(T(pv)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    live = want != -1.0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6)
    # and the JAX package's float32 device form, at its own tolerance
    # (test_chisq_jax.py:54)
    dev = np.asarray(chisq_jax.fisher_combine(jnp.asarray(pv)))
    np.testing.assert_array_equal(got == -1.0, dev == -1.0)
    np.testing.assert_allclose(got[live], dev[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("r", [2, 3, 5])
def test_fisher_combine_plain_matches_exact_engine(r):
    pv = _fisher_case(r=r, m=500, seed=r)
    pv[1, 100:120] = 0.0                  # zero totals with df > 2
    pv[:, 120:125] = 0.0
    ends = np.arange(1, pv.shape[1] + 1).astype(np.int64)
    want = echisq.combine_pvals([Pileup(ends, pv[i]) for i in range(r)],
                                pv.shape[1]).cov
    got = chisq.fisher_combine_plain(T(pv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fisher_combine_cpu_runs_plain_and_checks_shape():
    kernels.reset_launches()
    pv = T(_fisher_case())
    np.testing.assert_array_equal(chisq.fisher_combine(pv).numpy(),
                                  chisq.fisher_combine_plain(pv).numpy())
    assert kernels.LAUNCHES["fisher_combine"] == 0
    with pytest.raises(TypeError):
        chisq.fisher_combine(pv.double())
    with pytest.raises(ValueError):
        chisq.fisher_combine(torch.zeros((201, 4)))


# --- merge_fisher / rle_runs --------------------------------------------

def _coverage_pvals(seed, length=60_000):
    """One replicate's resident arrays from the JAX pipeline twin."""
    rng = np.random.RandomState(seed)
    n = 1500
    centers = rng.randint(500, length - 1500, 6)
    base = np.where(rng.rand(n) < 0.7,
                    centers[rng.randint(0, 6, n)] + rng.randint(0, 800, n),
                    rng.randint(0, length - 500, n))
    es = np.clip(base, 0, length - 2).astype(np.int32)
    ee = np.minimum(es + rng.randint(30, 400, n), length).astype(np.int32)
    ec = rng.choice([1, 1, 1, 2, 3, 4, 5, 6, 8, 10], n).astype(np.int32)
    cs = rng.randint(0, length - 500, 300).astype(np.int32)
    ce = (cs + rng.randint(30, 400, 300)).astype(np.int32)
    cc = np.ones(300, np.int32)
    excl = np.array([[4000, 9000], [30000, 30500], [length, length]],
                    np.int32)
    z4 = jnp.zeros(4, jnp.int32)
    s, e, ev, cr, ex, lv, _, _ = (np.asarray(x) for x in
                                  pipeline_jax.tile_coverage(
        *(jnp.asarray(a) for a in (es, ee, ec, cs, ce, cc, excl)),
        jnp.int32(length), z4, z4))
    pv = np.asarray(pipeline_jax.tile_stats(
        jnp.asarray(ev), jnp.asarray(cr), jnp.asarray(ex),
        jnp.float32(1.37), jnp.float32(0.61)))
    return s, e, ev, cr, ex, lv, pv, length


def _rle_pv_jax(seed):
    s, e, _, _, _, lv, pv, length = _coverage_pvals(seed)
    e_b, pv_b, b = compact_jax.rle_pv(jnp.asarray(s), jnp.asarray(e),
                                      jnp.asarray(pv), jnp.asarray(lv),
                                      jnp.int32(length))
    n = int(b)
    # the JAX engine keeps a power-of-two bucket; the port slices to the
    # run count: both end in (chrom_len, SKIP) padding
    return np.asarray(e_b)[:n + 3], np.asarray(pv_b)[:n + 3]


@pytest.mark.parametrize("r", [2, 3])
def test_merge_fisher_matches_jax(r):
    reps = [_rle_pv_jax(40 + i) for i in range(r)]
    want = [np.asarray(x) for x in compact_jax.merge_fisher(
        [jnp.asarray(e) for e, _ in reps],
        [jnp.asarray(p) for _, p in reps])]
    got = [x.numpy() for x in compact.merge_fisher(
        [T(e) for e, _ in reps], [T(p) for _, p in reps])]
    for i in (0, 1, 3):                   # starts, ends, live
        np.testing.assert_array_equal(got[i], want[i])
    assert got[2].dtype == np.float32
    live = want[3] & (want[2] != -1.0)
    assert live.sum() > 100
    np.testing.assert_array_equal(got[2] == -1.0, want[2] == -1.0)
    np.testing.assert_allclose(got[2][live], want[2][live], rtol=1e-4,
                               atol=1e-6)


def test_merge_fisher_matches_exact_engine():
    """Float64 combination: the exact engine's values, bitwise."""
    reps = [_rle_pv_jax(50 + i) for i in range(3)]
    _, ends, comb, live = (x.numpy() for x in compact.merge_fisher(
        [T(e) for e, _ in reps], [T(p) for _, p in reps]))
    want = echisq.combine_pvals(
        [Pileup(e.astype(np.int64), p) for e, p in reps], 60_000)
    np.testing.assert_array_equal(np.unique(ends[live]), want.end)
    k = np.searchsorted(want.end, ends[live])
    np.testing.assert_array_equal(comb[live], want.cov[k])


@pytest.mark.parametrize("seed", [61, 62])
def test_rle_runs_matches_jax(seed):
    s, e, ev, cr, ex, lv, pv, _ = _coverage_pvals(seed)
    lam, factor = F32(0.61), F32(1.37)
    want = [np.asarray(x) for x in compact_jax.rle_runs(
        *(jnp.asarray(a) for a in (s, e, pv, ev, cr, ex, lv)), lam,
        factor)]
    got = [x.numpy() for x in compact.rle_runs(
        *(T(a) for a in (s, e, pv, ev, cr, ex, lv)), lam, factor)]
    b = int(want[4])
    assert int(got[4]) == b and b > 100
    assert (want[3][:b] == -1.0).any()           # exclusions in the runs
    np.testing.assert_array_equal(got[0][:b], want[0][:b])
    for i in (1, 2, 3):
        np.testing.assert_allclose(got[i][:b], want[i][:b], rtol=1e-5,
                                   atol=1e-5)


def test_rle_runs_exclusion_values():
    """test_compact_jax.py::test_rle_runs_exclusion_values, ported."""
    args = [np.array([0, 10], np.int32), np.array([10, 20], np.int32),
            np.array([-1.0, 3.0], F32), np.array([5.0, 2.0], F32),
            np.array([4.0, 1.0], F32), np.array([1, 0], bool),
            np.ones(2, bool)]
    e_b, pv_b, ev_b, cv_b, b = compact.rle_runs(*(T(a) for a in args),
                                                F32(0.5), F32(1.0))
    assert int(b) == 2
    assert float(ev_b[0]) == 0.0 and float(cv_b[0]) == -1.0
    assert float(cv_b[1]) == 1.0

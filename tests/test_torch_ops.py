"""Port twins of ops/pileup_jax.py and ops/pvalue_jax.py on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
and its genrich_tpu_torch counterpart.  Coverage arithmetic is
integer-exact and must match bitwise; float32 p-values agree to
rtol = atol = 1e-5 (transcendentals from different libms); float64
p-values follow the exact engine.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401  (pins jax to the CPU before import)
import jax.numpy as jnp
import torch

from genrich_tpu.engine import pvalue as epvalue
from genrich_tpu.ops import pileup_jax, pvalue_jax
from genrich_tpu_torch.ops import pileup, pvalue


def test_class_tables_match_jax():
    np.testing.assert_array_equal(pileup.ADD, pileup_jax._ADD)
    np.testing.assert_array_equal(pileup.SUB, pileup_jax._SUB)
    # packed per-count tables equal pack_deltas of the table rows
    np.testing.assert_array_equal(
        pileup.PACKED_ADD,
        np.asarray(pileup_jax.pack_deltas(jnp.asarray(pileup_jax._ADD))))
    np.testing.assert_array_equal(
        pileup.PACKED_SUB,
        np.asarray(pileup_jax.pack_deltas(jnp.asarray(pileup_jax._SUB))))


@pytest.mark.parametrize("name", ["_A", "_B", "_C", "_D", "_P", "_Q"])
def test_pvalue_constants_match_jax(name):
    from genrich_tpu.engine import pvalue as ep
    np.testing.assert_array_equal(np.asarray(getattr(ep, name)),
                                  np.asarray(getattr(pvalue_jax, name)))


def test_scalar_constants_match_jax():
    from genrich_tpu.utils.cfloat import FLT_MAX, LOGSQRT, SQRTLOG
    assert LOGSQRT == pvalue_jax._LOGSQRT
    assert SQRTLOG == pvalue_jax._SQRTLOG
    assert FLT_MAX == pvalue_jax.FLT_MAX
    assert epvalue._M_LN10 == pvalue_jax._M_LN10


def _cum(rng, n):
    # cov may be negative (sub rows); the fraction classes never are
    return np.stack([rng.randint(-20, 50, n), rng.randint(0, 200, n),
                     rng.randint(0, 200, n), rng.randint(0, 200, n)],
                    axis=-1).astype(np.int32)


def test_canon_value_bitwise():
    cum = _cum(np.random.RandomState(0), 5000)
    ref = np.asarray(pileup_jax.canon_value(jnp.asarray(cum)))
    got = pileup.canon_value(torch.from_numpy(cum)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _deltas(rng, n, groups):
    cols = []
    for _ in range(groups):
        cols += [rng.randint(-1, 2, n), rng.randint(0, 8, n),
                 rng.randint(0, 4, n), rng.randint(0, 8, n)]
    return np.stack(cols, axis=-1).astype(np.int32)


@pytest.mark.parametrize("groups", [1, 2])
def test_pack_unpack_match_jax(groups):
    d = _deltas(np.random.RandomState(1), 3000, groups)
    ref = np.asarray(pileup_jax.pack_deltas(jnp.asarray(d)))
    got = pileup.pack_deltas(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, ref)
    back = pileup.unpack_deltas(torch.from_numpy(got), groups).numpy()
    np.testing.assert_array_equal(back, d)
    np.testing.assert_array_equal(
        back, np.asarray(pileup_jax.unpack_deltas(jnp.asarray(ref),
                                                  groups)))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_event_deltas_match_jax(dtype):
    count = np.random.RandomState(2).choice(
        [0, 1, 2, 3, 4, 5, 6, 8, 10], 1000).astype(dtype)
    add_r, sub_r = pileup_jax.event_deltas(jnp.asarray(count,
                                                       jnp.int32))
    add, sub = pileup.event_deltas(torch.from_numpy(count))
    assert add.shape == (1000, 4)
    np.testing.assert_array_equal(add.numpy(), np.asarray(add_r))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_r))


def test_sort_events_positions_and_totals():
    rng = np.random.RandomState(3)
    pos = rng.randint(0, 500, 2000).astype(np.int32)
    d = _deltas(rng, 2000, 1)
    p_r, d_r = pileup_jax.sort_events(jnp.asarray(pos), jnp.asarray(d))
    p_t, d_t = pileup.sort_events(torch.from_numpy(pos),
                                  torch.from_numpy(d))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_r))
    # unstable sorts: rows that share a position may permute, so the
    # cumulative sums agree at the last row of every position
    last = np.append(p_t.numpy()[1:] != p_t.numpy()[:-1], True)
    np.testing.assert_array_equal(np.cumsum(d_t.numpy(), 0)[last],
                                  np.cumsum(np.asarray(d_r), 0)[last])


def _pv_inputs(seed, n):
    rng = np.random.RandomState(seed)
    expt = rng.uniform(0.0, 60.0, n).astype(np.float32)
    ctrl = rng.uniform(0.01, 25.0, n).astype(np.float32)
    expt[:50] = 0.0
    ctrl[50:80] = 0.0
    ctrl[80:120] = -1.0
    expt[120:140] = rng.uniform(500, 5000, 20)   # far upper tail
    ctrl[140:160] = 7.0
    return expt, ctrl


def test_calc_pval_f32_matches_jax():
    expt, ctrl = _pv_inputs(4, 4000)
    ref = np.asarray(pvalue_jax.calc_pval(jnp.asarray(expt),
                                          jnp.asarray(ctrl)))
    got = pvalue.calc_pval(torch.from_numpy(expt),
                           torch.from_numpy(ctrl)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # edge cases are exact
    for sel in (ctrl == -1.0, ctrl == 0.0, expt == 0.0):
        np.testing.assert_array_equal(got[sel], ref[sel])


def test_pnorm_upper_log_f32_matches_jax():
    x = np.random.RandomState(5).uniform(-12, 40, 4000).astype(np.float32)
    ref = np.asarray(pvalue_jax.pnorm_upper_log(jnp.asarray(x)))
    got = pvalue.pnorm_upper_log(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_pnorm_upper_log_f64_matches_exact():
    """float64 follows the exact engine's pnorm; as in
    test_ops_jax.py:77 the agreement is held to rtol 1e-12 (torch's
    and numpy's libm may differ in the last ulp of log/exp)."""
    rng = np.random.RandomState(3)
    expt = rng.uniform(0.0, 50.0, 500).astype(np.float32)
    x = np.log(np.maximum(expt.astype(np.float64), 1e-30))
    x = np.concatenate([x, rng.uniform(-30, 30, 2000)])
    ref = epvalue.pnorm_upper_log(x)
    got = pvalue.pnorm_upper_log(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_calc_pval_f64_matches_exact_engine():
    """float64 calcPval rounded to float32 equals the exact engine's
    float32 result bitwise (the engine computes in float64 and rounds
    once at the end, so a last-ulp float64 difference only shows if it
    straddles a float32 rounding boundary)."""
    expt, ctrl = _pv_inputs(6, 4000)
    ref = epvalue.calc_pval(expt, ctrl)
    got = pvalue.calc_pval(torch.from_numpy(expt.astype(np.float64)),
                           torch.from_numpy(ctrl.astype(np.float64)))
    got32 = np.where(got.numpy() > float(np.finfo(np.float32).max),
                     np.finfo(np.float32).max,
                     got.numpy()).astype(np.float32)
    np.testing.assert_array_equal(got32, ref)

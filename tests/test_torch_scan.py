"""Kernel K1 (coverage scan) against the Pallas kernel and lax chain.

The plain PyTorch version runs here on the CPU against
``pallas_scan.coverage_pval_fused`` in interpret mode (the shapes of
test_pallas_scan.py) and against the lax chain inside
``pipeline_jax.tile_coverage``.  The CUDA kernel against the plain
version is in test_torch_kernels.py (it needs a card).  Tolerances:
coverage bitwise, -log10 p rtol = atol = 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401
import jax.numpy as jnp
import torch

from genrich_tpu.ops.pallas_scan import BLOCK, coverage_pval_fused
from genrich_tpu.ops.pileup_jax import (canon_value, pack_deltas,
                                        unpack_deltas)
from genrich_tpu.ops.pvalue_jax import calc_pval
from genrich_tpu_torch import kernels
from genrich_tpu_torch.ops import scan


def _deltas(rng, m, groups):
    cols = []
    for _ in range(groups):
        cols += [rng.randint(-1, 2, m), rng.randint(0, 8, m),
                 rng.randint(0, 3, m), rng.randint(0, 5, m)]
    return np.stack(cols, axis=-1).astype(np.int32)


def _packed(seed, m, groups):
    d = _deltas(np.random.RandomState(seed), m, groups)
    return np.array(pack_deltas(jnp.asarray(d)))


def test_plain_lambda_mode_matches_pallas_interpret():
    m = BLOCK * 4
    packed = _packed(0, m, 1)
    vals_ref, pval_ref = coverage_pval_fused(
        jnp.asarray(packed), jnp.float32(2.5), interpret=True)
    vals, pval = scan.coverage_pval_fused(torch.from_numpy(packed), 2.5)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_ref))
    np.testing.assert_allclose(pval.numpy(), np.asarray(pval_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 1000, 3 * 2048 + 77])
def test_plain_lambda_mode_ragged_matches_lax(m):
    """Any M (the Pallas kernel needs M % 1024 == 0; the port masks)."""
    packed = _packed(m, m, 1)
    d = unpack_deltas(jnp.asarray(packed), 1)
    vals_ref = canon_value(jnp.cumsum(d, axis=0))
    pval_ref = calc_pval(vals_ref, jnp.full(m, 0.75, jnp.float32))
    vals, pval = scan.coverage_pval_fused(torch.from_numpy(packed), 0.75)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_ref))
    np.testing.assert_allclose(pval.numpy(), np.asarray(pval_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [4096, 5000])
def test_plain_two_groups_matches_tile_coverage_chain(m):
    """G = 2 with carries: the lax chain at pipeline_jax.py:143-149."""
    packed = _packed(7, m, 2)
    carry_e = np.array([3, 5, 1, 9], np.int32)
    carry_c = np.array([0, 2, 4, 6], np.int32)
    d = unpack_deltas(jnp.asarray(packed), 2)
    cum = jnp.cumsum(d, axis=0)
    e_ref = canon_value(cum[:, :4] + jnp.asarray(carry_e)[None, :])
    c_ref = canon_value(cum[:, 4:] + jnp.asarray(carry_c)[None, :])
    vals, pval = scan.coverage_scan(
        torch.from_numpy(packed), 2,
        torch.from_numpy(np.concatenate([carry_e, carry_c])))
    assert pval is None and vals.shape == (2, m)
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(vals[1].numpy(), np.asarray(c_ref))


def test_cpu_tensor_runs_plain_version_without_launch():
    kernels.reset_launches()
    packed = torch.from_numpy(_packed(1, 2048, 2))
    scan.coverage_scan(packed, 2)
    assert kernels.LAUNCHES["coverage_scan"] == 0


@pytest.mark.parametrize("bad", ["dtype", "groups", "lam_g2", "carry"])
def test_wrapper_rejects_bad_arguments(bad):
    packed = torch.from_numpy(_packed(2, 64, 1))
    kw = {"packed": packed, "groups": 1}
    if bad == "dtype":
        kw["packed"] = packed.to(torch.int64)
    elif bad == "groups":
        kw["groups"] = 3
    elif bad == "lam_g2":
        kw.update(groups=2, lam=1.0)
    else:
        kw["carry"] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        scan.coverage_scan(**kw)

"""TorchEngine's replicate and log stages against JaxEngine, on the CPU.

The engine contract that ``genrich_tpu.pipeline`` drives for several
replicates (``archive_replicate``, ``finalize_fisher``) and for the
-f/-k logs (``pvalue_pileups``), fed the same numpy events as the JAX
engine.  Tolerances: breakpoints bitwise; combined -log10 p within
1e-4 relative (the JAX engine combines in float32, the port in
float64); RLE pileups ends bitwise, values rtol = atol = 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401  (pins jax to the CPU before import)

from genrich_tpu.engine.jax_bridge import JaxEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine

LENS = (60_000, 45_000)


def _events(seed, length, n=1200):
    rng = np.random.RandomState(seed)
    centers = rng.randint(500, length - 1500, 5)
    base = np.where(rng.rand(n) < 0.7,
                    centers[rng.randint(0, 5, n)] + rng.randint(0, 800, n),
                    rng.randint(0, length - 500, n))
    s = np.sort(np.clip(base, 0, length - 2)).astype(np.int64)
    e = np.minimum(s + rng.randint(30, 400, n), length).astype(np.int64)
    c = rng.choice([1, 1, 1, 2, 3, 4], n).astype(np.int64)
    return s, e, c


def _replicate(eng, seed, with_ctrl=False, widths=None):
    """Coverage and p-values of one replicate; ``widths`` (a dict) gets
    each chromosome's row count before ``stats_all`` merges the rows."""
    beds = ([2000, 5000], [])
    handles = []
    for cidx, length in enumerate(LENS):
        ctrl = _events(seed + 100 + cidx, length, 300) if with_ctrl \
            else None
        handles.append(eng.coverage_chrom(cidx, _events(seed + cidx,
                                                        length),
                                          ctrl, beds[cidx], length))
    frag, cfrag = eng.coverage_finish(handles)
    lam = np.float32(frag / sum(LENS))
    factor = np.float32(1.0) if cfrag == 0.0 else np.float32(frag / cfrag)
    if widths is not None:
        widths.update({c: st["starts"].shape[0]
                       for c, st in eng._chrom.items()})
    eng.stats_all(float(lam), float(factor))


def test_stats_all_keeps_coverage_until_a_device_only_stage():
    eng = TorchEngine("cpu")
    _replicate(eng, 3)
    assert eng._lam > 0 and eng._factor == np.float32(1.0)
    for st in eng._chrom.values():
        assert {"ev", "cr", "excluded", "pv"} <= st.keys()
    eng.pvalue_pileups(0)                  # the log path reads them
    eng.qvalue_table(sum(LENS))
    for st in eng._chrom.values():
        assert not {"ev", "cr", "excluded"} & st.keys()
    eng.release()
    _replicate(eng, 3)
    eng.peaks_submit(1, 2.0, 20.0, 0, 100, False)
    assert "ev" in eng._chrom[0] and "ev" not in eng._chrom[1]
    eng.release()


@pytest.mark.parametrize("with_ctrl", [False, True])
def test_pvalue_pileups_match_jax_engine(with_ctrl):
    jx, pt = JaxEngine(), TorchEngine("cpu")
    for eng in (jx, pt):
        _replicate(eng, 7, with_ctrl)
    for cidx in range(len(LENS)):
        want = jx.pvalue_pileups(cidx)
        got = pt.pvalue_pileups(cidx)
        for w, g in zip(want, got):
            if not with_ctrl:
                np.testing.assert_array_equal(g.end, w.end)
            # with a control, float32 -log10 p from two libms may split
            # a run in one engine and not the other (a run records its
            # last row's values): the rule of test_engine_jax_cli.py's
            # log test, on the run ends both engines have
            both = np.intersect1d(g.end, w.end)
            assert len(both) >= 0.99 * max(len(g.end), len(w.end))
            assert g.end[-1] == w.end[-1] == LENS[cidx]
            np.testing.assert_allclose(
                g.cov[np.searchsorted(g.end, both)],
                w.cov[np.searchsorted(w.end, both)], rtol=1e-5, atol=1e-5)
        assert (got[1].cov == -1.0).any() == (cidx == 0)   # -E on chrom 0
    jx.release()
    pt.release()


def test_archive_keeps_runs_only():
    eng = TorchEngine("cpu")
    widths = {}
    _replicate(eng, 11, widths=widths)
    eng.archive_replicate()
    assert not eng._chrom and len(eng._reps) == 1
    for cidx, (ends, pv, length) in eng._reps[0].items():
        assert length == LENS[cidx]
        assert 1 <= ends.shape[0] < widths[cidx]
        assert ends.untyped_storage().size() == ends.numel() * 4  # a copy
        assert int(ends[-1]) == length and bool((pv[:-1] != pv[1:]).all())
    eng.release()


def test_archive_of_an_empty_chromosome_keeps_one_row():
    eng = TorchEngine("cpu")
    eng.coverage_chrom(0, None, None, [], 5000)
    eng.coverage_chrom(1, _events(1, 50_000), None, [], 50_000)
    eng.stats_all(0.5, 1.0)
    eng.archive_replicate()
    ends, pv, _ = eng._reps[0][0]
    assert ends.tolist() == [5000] and pv.tolist() == [0.0]
    eng.release()


@pytest.mark.parametrize("n_reps", [2, 3])
def test_finalize_fisher_matches_jax_engine(n_reps):
    jx, pt = JaxEngine(), TorchEngine("cpu")
    for eng in (jx, pt):
        for r in range(n_reps):
            _replicate(eng, 20 + 10 * r)
            eng.archive_replicate()
        eng.finalize_fisher()
        assert not eng._reps
    for cidx in range(len(LENS)):
        w, g = jx._chrom[cidx], pt._chrom[cidx]
        wl, gl = np.asarray(w["live"]), g["live"].numpy()
        # the JAX engine keeps power-of-two buckets: its extra padding
        # rows merge into zero-length dead intervals
        np.testing.assert_array_equal(g["starts"].numpy()[gl],
                                      np.asarray(w["starts"])[wl])
        np.testing.assert_array_equal(g["ends"].numpy()[gl],
                                      np.asarray(w["ends"])[wl])
        wp, gp = np.asarray(w["pv"])[wl], g["pv"].numpy()[gl]
        np.testing.assert_array_equal(gp == -1.0, wp == -1.0)
        np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-6)
    jx.release()
    pt.release()

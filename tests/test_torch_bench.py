"""The port's bench (``genrich_tpu_torch/bench.py``) against the repo's.

At a small size on the CPU: ``compact_headline`` keeps the end-to-end
keys of ``bench.py``'s headline; ``_verify_rows`` is
``scripts/bench_e2e.py``'s; the flags of the retired kernel and scaling
legs are refused; and the end-to-end legs run on a small BAM with
``--device cpu``: every serve line OK, every output verified against the
exact engine, cold equal to warm.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import bench
from genrich_tpu_torch import bench as tbench

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
import bench_e2e  # noqa: E402
import perf_synth  # noqa: E402

SMALL = (("chr1", 40_000_000), ("chr2", 25_000_000))


def test_compact_headline_contract():
    """The last stdout line stays under 1,500 characters whatever the
    detail holds, carries the end-to-end keys of ``bench.py``'s headline,
    the detail's path and the card, and still prints when the end-to-end
    legs failed."""
    out = {
        "e2e": {"paired": {"ratio_median": 4.3, "ratio_spread_pct": 3.5},
                "jax_s": 2.1, "sharded_s": 2.2,
                "anything_huge": "x" * 100000},
        "detail": ".bench_cache/bench_torch_detail.json",
        "device": "NVIDIA H100 80GB HBM3, 700.00 W",
    }
    line = json.dumps(tbench.compact_headline(out))
    assert len(line) < 1500, len(line)
    parsed = json.loads(line)
    # bench.py's headline: its kernel legs' keys, then the end-to-end ones
    kernel_part = {
        "metric": "genome_positions_per_sec", "value": 2.9e9,
        "unit": "positions/s", "vs_baseline": 644.4,
        "kernel": {"roofline": {"frac_vs_ideal_sort": 0.51}},
        "kernel_production": {"positions_per_sec": 6.1e9,
                              "vs_baseline": 1355.6,
                              "roofline": {"frac_vs_ideal_sort": 0.4}}}
    e2e_keys = {k for k in bench.compact_headline({**kernel_part, **out})
                if k.startswith("e2e_")}
    assert len(e2e_keys) == 4
    assert set(parsed) == e2e_keys | {"detail", "device"}
    assert parsed["e2e_exact_ratio"] == 4.3 and parsed["e2e_jax_warm_s"] \
        == 2.1 and parsed["e2e_sharded_warm_s"] == 2.2
    assert parsed["detail"] == out["detail"]
    assert parsed["device"] == out["device"]
    out["e2e"] = {"error": "boom"}
    line2 = json.dumps(tbench.compact_headline(out))
    assert json.loads(line2)["e2e_exact_ratio"] is None


@pytest.mark.parametrize("flag", ["--kernel-only", "--scaling"])
def test_retired_legs_flags_are_usage_errors(flag, capsys):
    """The kernel and scaling legs are gone: their flags are argparse's
    usage error (exit code 2), before anything is measured."""
    with pytest.raises(SystemExit) as e:
        tbench.main([flag, "--device", "cpu"])
    assert e.value.code == 2
    assert f"unrecognized arguments: {flag}" in capsys.readouterr().err


def _peak_rows(rng, n, shift=0):
    rows = []
    for i in range(n):
        s = 1000 * i + shift * rng.randint(0, 3)
        q = rng.uniform(1.0, 5.0)
        rows.append(f"chr{1 + i % 2}\t{s}\t{s + rng.randint(50, 400)}\t"
                    f"peak_{i}\t0\t.\t{rng.uniform(20, 900):.6f}\t"
                    f"{q + 1:.6f}\t{q:.6f}\t{rng.randint(0, 50)}")
    return rows


def test_verify_rows_is_bench_e2e_s(tmp_path):
    rng = np.random.RandomState(4)
    ref = _peak_rows(rng, 300)
    out = _peak_rows(np.random.RandomState(4), 300, shift=1)[:280]
    out += [f"chr3\t{10 * i}\t{10 * i + 5}\tx\t0\t.\t1\t2\t"
            f"{1.30103 + 0.001 * i:.6f}\t0" for i in range(5)]
    a, b = tmp_path / "ref.np", tmp_path / "out.np"
    a.write_text("\n".join(ref) + "\n")
    b.write_text("\n".join(out) + "\n")
    for thresh in (1.3010299956639813, 2.0):
        want = bench_e2e._verify_rows(str(a), str(b), thresh)
        assert 0 < want["match_frac"] < 1 and want["worst_unmatched_margin"]
        assert tbench._verify_rows(str(a), str(b), thresh) == want
        assert tbench._verify_rows(str(a), str(a), thresh) \
            == bench_e2e._verify_rows(str(a), str(a), thresh)


def test_e2e_legs_on_the_cpu(tmp_path):
    """``atac`` (with its two-worker parser leg) and ``chip_fisher`` (the
    blacklist from the ATAC exact peaks, two replicates with their
    controls) on 20,000-pair BAMs, one rep, both device engines through
    their serve children (the sharded one in a one-rank gloo group)."""
    bams = {}
    for key, n, seed in (("A", 20_000, 7), ("B", 20_000, 8),
                         ("C", 10_000, 9)):
        bams[key] = str(tmp_path / f"{key}.bam")
        perf_synth.synth_bam(bams[key], n, seed=seed, chroms=SMALL)
    out = tbench.bench_e2e(bams, ["atac", "chip_fisher"], 1, device="cpu",
                           work=str(tmp_path), chroms=SMALL, timeout=300)
    assert out["ok"], {n: c["checks"] for n, c in out["configs"].items()}
    assert len(out["blacklist_cut"]) == 2
    for name, cfg in out["configs"].items():
        assert cfg["peaks"] > 0 and cfg["records"] > 40_000
        for eng in tbench.ENGINES:
            assert cfg[eng]["rows"]["match_frac"] >= 0.99
            assert len(cfg[eng]["rep_s"]) == 1 and cfg[eng]["cold_s"] > 0
            assert set(cfg[eng]["stages"]) == {"ingest_s", "device_rep_s",
                                               "findpeaks_s"}
            assert cfg[eng]["max_memory_allocated"] is None   # no card
            assert cfg["paired"][eng]["ratio_median"] > 0
        assert ("exact_par2" in cfg) == (name == "atac")
    assert out["paired"] == out["configs"]["atac"]["paired"]["jax"]
    assert out["jax_s"] > 0 and out["sharded_s"] > 0

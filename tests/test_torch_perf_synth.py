"""The port's BAM maker against the script it was copied from.

``genrich_tpu_torch/tools/perf_synth.py`` makes the benchmark's and
``chip_smoke.py``'s BAMs; it must write the same bytes as
``scripts/perf_synth.py`` for the same arguments, so that the BAMs
cached in ``.bench_cache/`` under their seed-named files stay valid.
"""

from __future__ import annotations

import hashlib
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu_torch.bench import HG_CHROMS  # noqa: E402
from genrich_tpu_torch.tools import perf_synth as port_synth  # noqa: E402

sys.path.insert(0, os.path.join(oracle.REPO, "scripts"))
import perf_synth as script_synth  # noqa: E402


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_port_copy_writes_the_scripts_bytes(tmp_path, seed):
    assert len(HG_CHROMS) == 3
    got, want = str(tmp_path / "port.bam"), str(tmp_path / "script.bam")
    port_synth.synth_bam(got, 2_000, seed=seed, chroms=HG_CHROMS)
    script_synth.synth_bam(want, 2_000, seed=seed, chroms=HG_CHROMS)
    assert _md5(got) == _md5(want)
    assert os.path.getsize(got) > 100_000

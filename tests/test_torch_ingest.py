"""Native ingest that the port builds (genrich_tpu_torch/ingest/native.py).

``build_native`` compiles the port's ``genrich_tpu_torch/native/ingest.cpp``
with the port's Makefile into a directory of its own, writing nothing
beside the sources and nothing under the repo's ``native/``; a port run
that loads the built library parses exactly as the Python reader does
(narrowPeak and the -k pileup log byte-equal).  ``ensure_native`` keeps
a built library that loads and builds one anew when it does not; the
CLI falls back to the Python reader with a one-line warning when no
library can be had.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu_torch import cli  # noqa: E402
from genrich_tpu_torch.ingest import native  # noqa: E402


JAX_NATIVE = os.path.join(oracle.REPO, "native")


def _tree(path):
    """(name, size, mtime) of each file of ``path``."""
    return sorted((f, os.stat(os.path.join(path, f)).st_size,
                   os.stat(os.path.join(path, f)).st_mtime_ns)
                  for f in os.listdir(path))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_build")
    before = _tree(JAX_NATIVE)
    info = native.build_native(d)
    return d, info, before


@pytest.fixture
def fresh_native(monkeypatch):
    """Start each test with no native library loaded."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "INFO", {})


def _run(tmp_path, name, sam, extra=()):
    d = tmp_path / name
    d.mkdir()
    rc = cli.main(["-t", sam, "-o", str(d / "out.np"), "-k",
                   str(d / "pile.k"), "-y", "-p", "0.01", "-a", "20",
                   "--device", "cpu"] + list(extra))
    assert rc == 0
    return [(d / f).read_bytes() for f in ("out.np", "pile.k")]


def test_build_native_into_a_directory(built, tmp_path):
    d, info, before = built
    assert os.path.dirname(info["path"]) == str(d)
    assert not info["cached"] and info["seconds"] > 0
    again = native.build_native(d)
    assert again["cached"] and again["path"] == info["path"]
    assert again["libdeflate"] == info["libdeflate"]
    # nothing is written beside the port's sources, and the repo's
    # native/ (the JAX package's) is left as it was
    assert native.NATIVE_DIR == native.Path(native.__file__).resolve() \
        .parent.parent / "native"
    assert sorted(os.listdir(native.NATIVE_DIR)) == ["Makefile",
                                                     "ingest.cpp"]
    assert _tree(JAX_NATIVE) == before
    assert [f for f, _, _ in before] == [
        "Makefile", "ingest.cpp", "libgenrich_ingest.so"]


def test_built_library_parses_like_the_python_reader(built, tmp_path,
                                                     fresh_native,
                                                     monkeypatch):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=57)
    bam = str(tmp_path / "in.bam")
    oracle.sam_to_bam(sam, bam)
    d, info, _ = built
    monkeypatch.setattr(native, "BUILD_DIR", d)
    nat = _run(tmp_path, "native", bam, ["-r", "-j"])
    assert native._lib is not None and native._lib._name == info["path"]
    py = _run(tmp_path, "python", bam, ["-r", "-j", "--ingest", "python"])
    assert nat == py and len(nat[0]) > 0


def test_ensure_native_keeps_a_library_that_loads(built, fresh_native,
                                                  monkeypatch):
    d, info, _ = built
    monkeypatch.setattr(native, "BUILD_DIR", d)
    got = native.ensure_native()
    assert got == {**info, "cached": True, "seconds": 0.0}
    assert native._lib._name == info["path"]


def test_ensure_native_builds_when_the_library_does_not_load(
        built, tmp_path, fresh_native, monkeypatch):
    """A library at the build's name that does not load (one built on
    another host) is built anew and loaded."""
    _, info, _ = built
    d = tmp_path / "build"
    d.mkdir()
    bad = d / os.path.basename(info["path"])
    bad.write_text("not a shared object")
    monkeypatch.setattr(native, "BUILD_DIR", d)
    got = native.ensure_native()
    assert not got["cached"] and got["path"] == str(bad)
    assert os.path.basename(info["path"]) in got["stale_error"]
    assert native._lib is not None and native._lib._name == str(bad)
    assert native.available()


def test_cli_warns_and_uses_the_python_reader_when_no_library(
        tmp_path, fresh_native, monkeypatch, capsys):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=58)
    empty = tmp_path / "no_sources"
    empty.mkdir()
    (empty / "ingest.cpp").write_text("#error no sources here\n")
    (empty / "Makefile").write_text(
        "all:\n\tfalse\n$(TARGET):\n\tfalse\n")
    monkeypatch.setattr(native, "NATIVE_DIR", empty)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out = _run(tmp_path, "fallback", sam)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "native ingest" in ln]
    assert len(lines) == 1 and lines[0].startswith("Warning! native "
                                                   "ingest unavailable")
    assert native._lib is None and not native.available()
    assert "error" in native.INFO
    assert not list((tmp_path / "build").glob("*.so"))
    assert out == _run(tmp_path, "python", sam, ["--ingest", "python"])


def test_pair_index_tab_without_the_symbol_falls_back(monkeypatch):
    """A library that loads but lacks ``gi_pair_index_tab`` (one built
    from older sources): ``pair_index_tab`` returns None, and the
    p-value stage takes numpy's route to the same rows and table."""
    import numpy as np
    from genrich_tpu_torch.engine import pvalue

    rng = np.random.default_rng(11)
    expt = rng.integers(0, 40, 5000).astype(np.float32) / 4
    ctrl = rng.integers(1, 9, 5000).astype(np.float32) / 2
    ctrl[rng.random(5000) < 0.05] = -1.0                 # SKIP rows
    ends = np.cumsum(rng.integers(1, 300, 5000)).astype(np.int64)
    key = (expt.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | ctrl.view(np.uint32).astype(np.uint64)
    uk = np.unique(key)
    want = pvalue.calc_pval_unique_tab(ends, expt, ctrl)

    class Stale:
        """A loaded library without the symbol."""
    monkeypatch.setattr(native, "_load", lambda: Stale())
    assert native.pair_index_tab(key, uk, ends) is None
    got = pvalue.calc_pval_unique_tab(ends, expt, ctrl)
    assert np.array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert np.array_equal(a, b)

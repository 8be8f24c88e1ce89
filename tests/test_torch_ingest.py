"""Native ingest that the port builds (genrich_tpu_torch/ingest.py).

``build_native`` compiles ``native/ingest.cpp`` with the repo's
Makefile into a directory of its own; a port run that loads the built
library parses exactly as the Python reader does (narrowPeak and the
-k pileup log byte-equal).  ``ensure_native`` keeps a library that
loads and builds one when it does not; the CLI falls back to the
Python reader with a one-line warning when no library can be had.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu.ingest import native  # noqa: E402
from genrich_tpu_torch import cli, ingest  # noqa: E402


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_build")
    info = ingest.build_native(d)
    return d, info


@pytest.fixture
def fresh_native(monkeypatch):
    """Start each test with no native library loaded."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", native._SO)
    monkeypatch.setattr(ingest, "INFO", {})


def _run(tmp_path, name, sam, extra=()):
    d = tmp_path / name
    d.mkdir()
    rc = cli.main(["-t", sam, "-o", str(d / "out.np"), "-k",
                   str(d / "pile.k"), "-y", "-p", "0.01", "-a", "20",
                   "--device", "cpu"] + list(extra))
    assert rc == 0
    return [(d / f).read_bytes() for f in ("out.np", "pile.k")]


def test_build_native_into_a_directory(built, tmp_path):
    d, info = built
    assert os.path.dirname(info["path"]) == str(d)
    assert not info["cached"] and info["seconds"] > 0
    again = ingest.build_native(d)
    assert again["cached"] and again["path"] == info["path"]
    assert again["libdeflate"] == info["libdeflate"]
    # nothing is written into native/
    assert sorted(os.listdir(ingest.NATIVE_DIR)) == [
        "Makefile", "ingest.cpp", "libgenrich_ingest.so"]


def test_built_library_parses_like_the_python_reader(built, tmp_path,
                                                     fresh_native):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=57)
    bam = str(tmp_path / "in.bam")
    oracle.sam_to_bam(sam, bam)
    _, info = built
    native._SO = info["path"]
    nat = _run(tmp_path, "native", bam, ["-r", "-j"])
    assert native._lib is not None and native._lib._name == info["path"]
    py = _run(tmp_path, "python", bam, ["-r", "-j", "--ingest", "python"])
    assert nat == py and len(nat[0]) > 0


def test_ensure_native_keeps_a_library_that_loads(built, fresh_native):
    _, info = built
    native._SO = info["path"]
    got = ingest.ensure_native()
    assert got == {"path": info["path"], "built": False}
    assert native._SO == info["path"]


def test_ensure_native_builds_when_the_library_does_not_load(
        built, tmp_path, fresh_native, monkeypatch):
    d, info = built
    bad = tmp_path / "libbroken.so"
    bad.write_text("not a shared object")
    native._SO = str(bad)
    monkeypatch.setattr(ingest, "BUILD_DIR", d)
    got = ingest.ensure_native()
    assert got["built"] and got["path"] == info["path"]
    assert "libbroken.so" in got["committed_error"]
    assert native._SO == info["path"] and native._lib is None
    assert native.available(build=False)


def test_cli_warns_and_uses_the_python_reader_when_no_library(
        tmp_path, fresh_native, monkeypatch, capsys):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=58)
    bad = tmp_path / "libbroken.so"
    bad.write_text("not a shared object")
    native._SO = str(bad)
    empty = tmp_path / "no_sources"
    empty.mkdir()
    (empty / "ingest.cpp").write_text("#error no sources here\n")
    (empty / "Makefile").write_text(
        "all:\n\tfalse\n$(TARGET):\n\tfalse\n")
    monkeypatch.setattr(ingest, "NATIVE_DIR", empty)
    monkeypatch.setattr(ingest, "BUILD_DIR", tmp_path / "build")
    out = _run(tmp_path, "fallback", sam)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "native ingest" in ln]
    assert len(lines) == 1 and lines[0].startswith("Warning! native "
                                                   "ingest unavailable")
    assert native._lib is None
    assert out == _run(tmp_path, "python", sam, ["--ingest", "python"])

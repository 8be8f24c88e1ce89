"""Import and fallback guards of the port's CLI.

The port never imports jax; ``--device cuda`` with no card is an error,
never a silent switch to the CPU; ``--serve`` and ``--engine``, whose
paths are not ported, fail with "not yet ported to genrich_tpu_torch".
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

MARK = "not yet ported to genrich_tpu_torch"


def _env():
    env = {**os.environ, "PYTHONPATH": oracle.REPO}
    env.pop("JAX_PLATFORMS", None)
    return env


def _port(args, cwd):
    return subprocess.run([sys.executable, "-m", "genrich_tpu_torch"]
                          + args, cwd=cwd, capture_output=True,
                          text=True, env=_env())


@pytest.fixture
def sam(tmp_path):
    path = tmp_path / "in.sam"
    oracle.random_sam(str(path), seed=5, n_pairs=120)
    return str(path)


def test_cpu_run_never_imports_jax(tmp_path, sam):
    code = ("import sys\n"
            "from genrich_tpu_torch.cli import main\n"
            f"rc = main(['-t', {sam!r}, '-o', 'out.np', '-y', '-p', "
            "'0.05', '-a', '5', '--device', 'cpu'])\n"
            "assert rc == 0, rc\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    assert (tmp_path / "out.np").exists()


@pytest.mark.parametrize("flags", [
    ["-f", "f.log", "-k", "k.log"], ["-X", "-f", "f.log"], "two_reps"])
def test_cpu_run_never_imports_jax_on_other_paths(tmp_path, sam, flags):
    args = ["-t", f"{sam},{sam}", "-o", "out.np", "-y", "-a", "5"] \
        if flags == "two_reps" \
        else ["-t", sam, "-o", "out.np", "-y", "-a", "5"] + flags
    code = ("import sys\n"
            "from genrich_tpu_torch.cli import main\n"
            f"rc = main({args + ['--device', 'cpu']!r})\n"
            "assert rc == 0, rc\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    assert (tmp_path / "f.log").exists() or flags == "two_reps"


def test_every_module_imports_without_jax(tmp_path):
    """Every module of the package (the profiler and the helpers that
    chip_smoke.py imports among them) loads without jax and without
    building or launching anything."""
    code = ("import importlib, pkgutil, sys\n"
            "import genrich_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, 'genrich_tpu_torch.')\n"
            "         if not m.name.endswith('__main__')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "from genrich_tpu_torch import kernels\n"
            "assert kernels._lib is None\n"
            "print('MODULES', len(names))\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    assert int(r.stdout.split("MODULES")[1].split()[0]) >= 15


def test_cuda_without_card_fails_clearly(tmp_path, sam):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would run")
    r = _port(["-t", sam, "-o", "out.np", "-y", "--device", "cuda"],
              str(tmp_path))
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "Error!" in r.stderr
    assert not (tmp_path / "out.np").exists()


def test_default_device_is_cuda(tmp_path, sam):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run")
    r = _port(["-t", sam, "-o", "out.np", "-y"], str(tmp_path))
    assert r.returncode == 1 and "CUDA" in r.stderr


@pytest.mark.parametrize("flags", [["--serve"], ["--engine", "jax"]])
def test_unported_flags_rejected(tmp_path, sam, flags):
    args = ["-t", sam, "-o", "out.np", "-y"] + flags
    r = _port(args + ["--device", "cpu"], str(tmp_path))
    assert r.returncode == 1, r.stderr
    assert MARK in r.stderr
    assert not (tmp_path / "out.np").exists()


def test_bad_device_rejected(tmp_path, sam):
    r = _port(["-t", sam, "-o", "out.np", "--device", "tpu"],
              str(tmp_path))
    assert r.returncode == 1 and "--device" in r.stderr

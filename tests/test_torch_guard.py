"""Import and fallback guards of the port's CLI.

The port never imports jax; ``--device cuda`` with no card is an error,
never a silent switch to the CPU; flags whose path is not ported fail
with "not yet ported to genrich_tpu_torch".
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


@pytest.mark.parametrize("flags", [
    ["-f", "log.txt"], ["-k", "pile.txt"], ["-X"], ["--serve"],
    ["--engine", "jax"], "two_reps"])
def test_unported_flags_rejected(tmp_path, sam, flags):
    if flags == "two_reps":
        args = ["-t", f"{sam},{sam}", "-o", "out.np", "-y"]
    else:
        args = ["-t", sam, "-o", "out.np", "-y"] + flags
    r = _port(args + ["--device", "cpu"], str(tmp_path))
    assert r.returncode == 1, r.stderr
    assert MARK in r.stderr
    assert not (tmp_path / "out.np").exists()


def test_peaks_only_rejected(tmp_path):
    r = _port(["-P", "-f", "x.log", "-o", "out.np", "--device", "cpu"],
              str(tmp_path))
    assert r.returncode == 1 and MARK in r.stderr


def test_bad_device_rejected(tmp_path, sam):
    r = _port(["-t", sam, "-o", "out.np", "--device", "tpu"],
              str(tmp_path))
    assert r.returncode == 1 and "--device" in r.stderr

"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests`` from the root of the repository).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda`` fixture, which skips them on a host without one.  ``tiny``
makes a cell's configuration small enough for the CPU: every length,
depth and site count times ``scale``, with stronger sites so that a few
hundred kbp still call peaks.
"""

import copy
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(name, scale=1e-3, sites=10, frip=0.6, chroms=3):
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["genome"] = [[n, max(int(ln * scale), 20000)]
                     for n, ln in cfg["genome"]][:chroms]
    for f in cfg["sample"]["files"]:
        f["pairs"] = int(f["pairs"] * scale)
    cfg["sample"]["sites"].update(count=sites, frip=frip)
    if "exclusions" in cfg:
        cfg["exclusions"].update(blacklist_regions=6, blacklist_bp=2000)
    return cfg


@pytest.fixture(scope="session")
def tiny_cfg():
    return tiny

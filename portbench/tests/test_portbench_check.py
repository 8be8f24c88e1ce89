"""The comparison that decides ``correct``, run through the harness on
the CPU at a tiny size: the port (its plain PyTorch kernels) passes;
an output rounded as a lower precision would round it, the control
(the reference in bfloat16 in the program's place) and a run with the
timed path broken underneath each fail.  The card test runs the
control at a larger size on a CUDA card."""

import numpy as np
import pytest
import torch

from portbench import harness, run as runmod
from portbench.reference.compare import compare, parse

CELLS = ["atac_published", "chip_tf_encode"]


def _run(cfg, tmpdir, device="cpu"):
    return harness.run_cell({"name": "tiny", "chips": 1}, cfg, {"pool": 2},
                            2 ** 31 + 5, 0.01, 0, device, tmpdir=str(tmpdir))


def _judge(r):
    return runmod.judge(r)[0]


@pytest.fixture(scope="module", params=CELLS)
def sound(request, tiny_cfg, tmp_path_factory):
    r = _run(tiny_cfg(request.param), tmp_path_factory.mktemp("sound"))
    return request.param, r


def test_port_is_correct(sound):
    name, r = sound
    assert r["failed"] == 0 and min(r["info"]["peaks"]) > 0, r["errors"]
    assert _judge(r), runmod.judge(r)[1]


def _bf16(x):
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16) \
        .to(torch.float64).numpy()


def test_lower_precision_output_fails(sound):
    name, r = sound
    c = r["cell_obj"]
    use_q = harness.thresholds(c.config["flags"])["qval"]
    limits = c.config["limits"]
    for i, outs in enumerate(c.outputs):
        want, _ = c.reference(i)
        for data in outs.values():
            got = {ch: (s, e, _bf16(a), _bf16(p), _bf16(q) if use_q else q,
                        m) for ch, (s, e, a, p, q, m)
                   in parse(data.decode()).items()}
            nums = compare(got, want, use_q)[0]
            assert any(nums[k] > limits[k] for k in limits), nums


def test_control_fails(sound):
    name, r = sound
    c = r["cell_obj"]
    limits = c.config["limits"]
    nums = c.control(0, torch.bfloat16)
    assert any(nums[k] > limits[k] for k in limits), nums


def _fault_stats_unchanged(monkeypatch):
    from genrich_tpu_torch.engine import torch_bridge
    monkeypatch.setattr(torch_bridge, "tile_stats",
                        lambda ev, *a: torch.zeros_like(ev))


def _fault_half_batch(monkeypatch):
    from genrich_tpu_torch.engine.torch_bridge import TorchEngine
    real = TorchEngine._events

    def half(self, ev):
        if ev is None:
            return real(self, ev)
        return real(self, tuple(np.asarray(a)[::2] for a in ev))
    monkeypatch.setattr(TorchEngine, "_events", half)


def _fault_answer_altered(monkeypatch):
    from genrich_tpu_torch import pipeline
    real = pipeline.writers.write_peak

    def altered(out, name, peak, count):
        if count == 0:
            peak.end += 1
        return real(out, name, peak, count)
    monkeypatch.setattr(pipeline.writers, "write_peak", altered)


@pytest.mark.parametrize("fault", [_fault_stats_unchanged,
                                   _fault_half_batch,
                                   _fault_answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(monkeypatch, tmp_path, tiny_cfg, fault,
                                    name):
    fault(monkeypatch)
    assert not _judge(_run(tiny_cfg(name), tmp_path))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_card_port_correct_and_control_fails(cuda, tmp_path, tiny_cfg, name):
    r = _run(tiny_cfg(name, scale=2e-2, sites=400, chroms=25), tmp_path,
             cuda)
    assert _judge(r), runmod.judge(r)[1]
    c = r["cell_obj"]
    limits = c.config["limits"]
    for i in range(len(c.pool)):
        nums = c.control(i, torch.bfloat16)
        assert any(nums[k] > limits[k] for k in limits), nums

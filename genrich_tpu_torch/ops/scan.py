"""Coverage scan over sorted packed class deltas (kernel K1).

Twin of ``genrich_tpu/ops/pallas_scan.py::coverage_pval_fused`` (the
repo's one Pallas kernel, pallas_scan.py:82-113) and of the lax chain
inside ``genrich_tpu/ops/pipeline_jax.py::tile_coverage`` (:143-149):
unpack G groups of class deltas, inclusive prefix sum plus a carry,
``canon_value`` per group, and in lambda mode (G == 1) ``calc_pval``
against a scalar background.

On a CUDA tensor the wrapper launches ``csrc/scan.cu`` (CUDA C++,
sm_90a).  It is bound by device-memory bandwidth: the main-path mode
(G = 2, no p) moves 4 B in and 8 B out per row.  TPU grid steps ran in
order and carried the running sum in scalar memory; Hopper blocks run
in no order, so the kernel is one launch of a single-pass scan with
decoupled look-back: each tile publishes its sums, and a tile finds its
prefix from its predecessors' (see the source).  On a CPU tensor the
wrapper runs the plain PyTorch version below; there is no fallback from
one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .pileup import canon_value, unpack_deltas
from .pvalue import calc_pval


def coverage_scan_plain(packed: torch.Tensor, groups: int,
                        carry: torch.Tensor,
                        lam: Optional[float] = None):
    """Plain PyTorch version: (vals [groups, M], pval [M] or None)."""
    # channel-major [4 * groups, M], so each cumsum runs along the
    # contiguous dimension (a scan along dim 0 of [M, C] is a slow
    # sequential kernel on CUDA)
    deltas = unpack_deltas(packed, groups).T.contiguous()
    cum = torch.cumsum(deltas, dim=1, dtype=torch.int32)
    cum = cum + carry.to(torch.int32)[:, None]
    vals = torch.stack([canon_value(cum[4 * g:4 * g + 4].T)
                        for g in range(groups)])
    pval = None
    if lam is not None:
        pval = calc_pval(vals[0], torch.full_like(vals[0], lam))
    return vals, pval


def _check(packed, groups, carry, lam):
    if packed.dtype != torch.int32 or packed.dim() != 1:
        raise TypeError("packed must be a 1-D int32 tensor")
    if groups not in (1, 2):
        raise ValueError(f"groups must be 1 or 2, not {groups}")
    if lam is not None and groups != 1:
        raise ValueError("lambda mode needs groups == 1")
    if carry.shape != (4 * groups,):
        raise ValueError(f"carry must have shape ({4 * groups},)")
    if carry.device != packed.device:
        raise ValueError("carry and packed must share a device")


def _coverage_scan_cuda(packed: torch.Tensor, groups: int,
                        carry: torch.Tensor, lam: Optional[float]):
    """Launch csrc/scan.cu on the card: (vals [groups, M], pval|None)."""
    packed = kernels.aligned(packed.contiguous(), 16)
    carry = carry.to(torch.int32).contiguous()
    m = packed.shape[0]
    with torch.cuda.device(packed.device):
        lib = kernels.library()
        dev = packed.device
        vals = torch.empty((groups, m), dtype=torch.float32, device=dev)
        pval = torch.empty(m if lam is not None else 0,
                           dtype=torch.float32, device=dev)
        # tile counter, per-tile flags and sums; zeroed by the launch
        scratch = torch.empty(lib.coverage_scan_scratch(m, groups),
                              dtype=torch.int32, device=dev)
        rc = lib.coverage_scan_launch(
            kernels.ptr(packed), m, groups, kernels.ptr(carry),
            float(np.float32(0.0 if lam is None else lam)),
            int(lam is not None), kernels.ptr(vals), kernels.ptr(pval),
            kernels.ptr(scratch), kernels.stream_of(packed))
        kernels.check(rc, "coverage_scan")
    kernels.count("coverage_scan", dev)
    return vals, (pval if lam is not None else None)


def coverage_scan(packed: torch.Tensor, groups: int,
                  carry: Optional[torch.Tensor] = None,
                  lam: Optional[float] = None):
    """Coverage (and lambda-mode p) from sorted packed deltas.

    packed: int32 [M], sorted by position; carry: int32 [4 * groups]
    class sums entering the first row (zeros by default); lam: scalar
    background rate, G == 1 only.  CUDA tensors go to the kernel, CPU
    tensors to the plain version.
    """
    if carry is None:
        carry = torch.zeros(4 * groups, dtype=torch.int32,
                            device=packed.device)
    _check(packed, groups, carry, lam)
    if packed.device.type == "cuda":
        return _coverage_scan_cuda(packed, groups, carry, lam)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    return coverage_scan_plain(packed, groups, carry, lam)


def coverage_pval_fused(packed: torch.Tensor, lam: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coverage values, -log10 p) -- pallas_scan's API, any M."""
    vals, pval = coverage_scan(packed, 1, lam=lam)
    return vals[0], pval

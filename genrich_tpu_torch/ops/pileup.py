"""Sorted events -> class-separated coverage (twin of ops/pileup_jax.py).

The reference's per-base diff-array sweep (savePileupExpt,
Genrich.c:2168-2295) is a sort of per-event class deltas, a cumulative
sum and a canonicalisation; ``engine/pileup.py`` (the port's copy of
the exact engine's module) derives the four integer classes (cov, e8,
s6, t10).  The class tables are rebuilt here from that module's
``_ADD_*``/``_SUB_*`` columns.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..engine.pileup import (_ADD_COV, _ADD_E8, _ADD_S6, _ADD_T10,
                             _SUB_COV, _SUB_E8, _SUB_S6, _SUB_T10)

# per-class raw contributions indexed by count code N (0..10): [11, 4]
ADD = np.stack([_ADD_COV, _ADD_E8, _ADD_S6, _ADD_T10], axis=1) \
    .astype(np.int32)
SUB = np.stack([_SUB_COV, _SUB_E8, _SUB_S6, _SUB_T10], axis=1) \
    .astype(np.int32)


def _pack4(d: np.ndarray) -> np.ndarray:
    return ((d[..., 0] + 1) | (d[..., 1] << 2) | (d[..., 2] << 5)
            | (d[..., 3] << 7)).astype(np.int32)


# one 10-bit packed group per count code (see pack_deltas)
PACKED_ADD = _pack4(ADD)
PACKED_SUB = _pack4(SUB)
PACKED_ZERO = 1          # the packed group of four zero deltas

# constant tables on each device a call asked for them on: a copy from
# host memory waits until the device's queue has drained, so a call
# that needs a table reads the copy made on its device's first call
_TABLES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def device_table(arr: np.ndarray, device) -> torch.Tensor:
    """``arr``, a module constant, on ``device``: copied there once."""
    key = (id(arr), torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(arr, device=device)
    return t


def event_deltas(count: torch.Tensor):
    """Map event count codes to (add, sub) class-delta rows [E, 4].

    ``count`` may be uint8: it is cast to int64 first, because indexing
    with a uint8 tensor is a boolean mask in torch, not a gather.
    """
    idx = count.long()
    return (device_table(ADD, count.device)[idx],
            device_table(SUB, count.device)[idx])


def canon_value(cum: torch.Tensor) -> torch.Tensor:
    """Canonical float32 value from cumulative class sums [..., 4].

    getVal (Genrich.c:1902-1907): left-associated float32 additions of
    cov + e/8 + s/6 + t/10 after carry normalisation.  The raw ``cov``
    channel may be negative (sub rows carry -1 against a +4 e8 half);
    only the e8/s6/t10 channels are divided, and they never are, so
    floor and truncating division agree (the CUDA kernel truncates).
    """
    cov, e8, s6, t10 = (cum[..., 0], cum[..., 1], cum[..., 2],
                        cum[..., 3])
    if __debug__ and cum.numel():
        assert bool((cum[..., 1:] >= 0).all()), \
            "negative fraction class sum"
    halves = e8 // 4 + s6 // 3 + t10 // 5
    covc = cov + halves // 2
    e = e8 % 4 + 4 * (halves % 2)
    s = s6 % 3
    t = t10 % 5
    v = covc.to(torch.float32)
    v = v + e.to(torch.float32) / 8.0
    v = v + s.to(torch.float32) / 6.0
    v = v + t.to(torch.float32) / 10.0
    return v


def pack_deltas(deltas: torch.Tensor) -> torch.Tensor:
    """Pack 4 (or 8) int32 delta channels into one int32 payload.

    Field widths: cov+1 in 2 bits, e8 in 3, s6 in 2, t10 in 3 -- 10
    bits per 4-channel group, so an expt+ctrl pair fits in 20 bits.
    """
    n = deltas.shape[-1] // 4
    packed = torch.zeros(deltas.shape[:-1], dtype=torch.int32,
                         device=deltas.device)
    for g in range(n):
        b = deltas[..., 4 * g:4 * g + 4].to(torch.int32)
        grp = ((b[..., 0] + 1) | (b[..., 1] << 2) | (b[..., 2] << 5)
               | (b[..., 3] << 7))
        packed = packed | (grp << (10 * g))
    return packed


def unpack_deltas(packed: torch.Tensor, groups: int = 1) -> torch.Tensor:
    chans = []
    for g in range(groups):
        grp = (packed >> (10 * g)) & 0x3FF
        chans += [(grp & 3) - 1, (grp >> 2) & 7, (grp >> 5) & 3,
                  (grp >> 7) & 7]
    return torch.stack(chans, dim=-1)


def sort_events(pos: torch.Tensor, deltas: torch.Tensor):
    """Sort events by position, carrying the 4 delta channels.

    pos: int32 [M]; deltas: int32 [M, 4].  Unstable, like the JAX
    twin: rows that share a position may come out in any order, so
    consumers compare only rows of length > 0.
    """
    pos_s, order = torch.sort(pos)
    packed_s = pack_deltas(deltas)[order]
    return pos_s, unpack_deltas(packed_s, 1)

"""Host staging of the event triples that ``TorchEngine`` uploads.

Ingest hands each chromosome's events over as int64 starts and ends and
int32 count codes (the pure-Python ingest as int64 arrays); the device
takes int32 starts and ends and uint8 codes.  ``EventStager`` narrows
each array once, straight into one of two host slots that live as long
as the stager, then copies the slot onto the device into freshly
allocated tensors of the same dtypes and lengths.

The narrowing is torch's CPU copy, ``slot[:n].copy_(torch.from_numpy(a))``:
C's truncating conversion, which is numpy's wrap-around (``casting=
"unsafe"``, as ``np.asarray(x, np.int32)`` and ``np.asarray(x, np.uint8)``
cast an integer array), spread by ATen over the process's intra-op
threads once an array passes its grain (32,768 elements), serial below
it.  A layout that ``torch.from_numpy`` cannot view (a negative stride,
a non-native byte order) raises; ingest hands over neither.

On a CUDA device the slots are page-locked and the copies are
``non_blocking``: the card's copy engine reads the slot by DMA, with no
pageable copy through a bounce buffer, while the host goes on.  A CUDA
event recorded behind a slot's copies is waited for before the slot is
written again.  On the CPU nothing is pinned and each copy is a plain
one, so no tensor handed out aliases a slot.

A slot grows only when a chromosome does not fit it, to an eighth more
than the largest chromosome seen, so that a slot first filled by a
smaller one, or the next sample of about the same size, does not grow
it again; after warm-up no analysis allocates host memory here.
``perf`` counts ``stage_bytes`` (the bytes narrowed into a slot),
``stage_alloc_n`` (slot allocations) and ``stage_wait_s`` (host seconds
blocked on a slot's event, inside ``upload_s``).
"""

from __future__ import annotations

import numpy as np
import torch

from .perf import span

DTYPES = (torch.int32, torch.int32, torch.uint8)


class _Slot:
    """One (starts, ends, codes) triple of host buffers and the event
    behind their last copies (CUDA only)."""

    __slots__ = ("size", "host", "event")

    def __init__(self, size: int, pin: bool):
        self.size = size
        self.host = tuple(torch.empty(size, dtype=dt, pin_memory=pin)
                          for dt in DTYPES)
        self.event = torch.cuda.Event() if pin else None


class EventStager:
    """Two reused host slots between ingest's event triples and the
    device (see the module's docstring)."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self._pin = device.type == "cuda"
        self._slots = [None] * self.SLOTS
        self._next = 0
        self._largest = 0

    def _slot(self, n: int, perf: dict) -> _Slot:
        """The next slot, once its last copies are done, holding at
        least ``n`` events."""
        i = self._next
        self._next = (i + 1) % self.SLOTS
        slot = self._slots[i]
        if slot is not None and slot.event is not None:
            with span("pipeline.upload", perf, "upload_s") as wait:
                slot.event.synchronize()
            perf["stage_wait_s"] += wait.seconds
        self._largest = max(self._largest, n)
        if slot is None or slot.size < n:
            slot = self._slots[i] = _Slot(
                self._largest + (self._largest >> 3), self._pin)
            perf["stage_alloc_n"] += 1
        return slot

    def put(self, ev, perf: dict) -> tuple:
        """(starts int32, ends int32, count codes uint8) of the non-empty
        event triple ``ev`` (arrays or lists) as new device tensors,
        accounted as three uploads."""
        n = len(ev[0])
        slot = self._slot(n, perf)
        with span("pipeline.cast", perf, "cast_s"):
            for a, host in zip(ev, slot.host):
                host[:n].copy_(torch.from_numpy(np.asarray(a)))
        with span("pipeline.upload", perf, "upload_s"):
            out = tuple(torch.empty(n, dtype=h.dtype, device=self.device)
                        .copy_(h[:n], non_blocking=self._pin)
                        for h in slot.host)
            if slot.event is not None:
                slot.event.record(torch.cuda.current_stream(self.device))
        nbytes = sum(h[:n].nbytes for h in slot.host)
        perf["upload_n"] += len(out)
        perf["upload_bytes"] += nbytes
        perf["stage_bytes"] += nbytes
        return out

"""Per-analysis device-path accounting (twin of engine/perf.py).

The same ``perf`` keys as the JAX engines: bytes, count and host wall
of host->device uploads, count and host wall of kernel/program
submissions (asynchronous on the card), and count and wall of blocking
device->host pulls.  Every host sync the engine makes (``.item()``,
``.cpu()``, boolean-mask reads) goes through ``_fetch``/``_fetch_many``
so that ``fetch_n`` counts it.  The peak stage's host seconds split
into ``peak_fetch_s`` (the engine's ``peaks_fetch``: the wait for the
device, and on the sharded engine its boundary merge, ``peak_merge_s``)
and ``peak_write_s`` (the narrowPeak writer).
"""

from __future__ import annotations

import time

import numpy as np
import torch


class PerfMixin:
    """upload/dispatch/fetch counters; engines call the helpers.

    The engine sets ``self.device`` (a ``torch.device``); a sharded engine
over several cards fetches from each, one accounted fetch a card.
    """

    def begin_run(self) -> None:
        """Reset the per-analysis accounting."""
        self.perf = {"upload_bytes": 0, "upload_n": 0,
                     "upload_s": 0.0, "dispatch_n": 0,
                     "dispatch_s": 0.0, "fetch_n": 0, "fetch_s": 0.0,
                     "peak_fetch_s": 0.0, "peak_write_s": 0.0}

    def _put(self, arr, device=None):
        """Host array -> tensor on ``device`` (``self.device`` by
        default), accounted."""
        t0 = time.perf_counter()
        out = torch.as_tensor(np.ascontiguousarray(arr),
                              device=self.device if device is None
                              else device)
        p = self.perf
        p["upload_n"] += 1
        p["upload_bytes"] += getattr(arr, "nbytes", 0)
        p["upload_s"] += time.perf_counter() - t0
        return out

    def _call(self, fn, *args, **kw):
        """Run a tensor program, accounted (asynchronous on the card)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        p = self.perf
        p["dispatch_n"] += 1
        p["dispatch_s"] += time.perf_counter() - t0
        return out

    def _fetch(self, x):
        """Device tensor -> numpy (blocking), accounted."""
        t0 = time.perf_counter()
        out = x.cpu().numpy()
        p = self.perf
        p["fetch_n"] += 1
        p["fetch_s"] += time.perf_counter() - t0
        return out

    def _fetch_many(self, xs):
        """Several device tensors -> numpy, counted as one fetch a device
        they lie on.

        The first ``.cpu()`` from a device waits for its stream; the
        rest copy data that is already there.
        """
        t0 = time.perf_counter()
        out, devices = [], set()
        for x in xs:
            devices.add(x.device)
            out.append(x.cpu().numpy())
        p = self.perf
        p["fetch_n"] += max(len(devices), 1)
        p["fetch_s"] += time.perf_counter() - t0
        return tuple(out)


def cuda_cards() -> range:
    """The indices of the CUDA cards this process sees (none without
    CUDA)."""
    return range(torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)


def synchronize_cards() -> None:
    """Wait for every card this process sees, not only the current
    one (``torch.cuda.synchronize()`` waits for one device)."""
    for i in cuda_cards():
        torch.cuda.synchronize(i)


def reset_peak_memory() -> None:
    """Reset the peak-memory statistics of every card."""
    for i in cuda_cards():
        torch.cuda.reset_peak_memory_stats(i)


def peak_memory() -> list:
    """``torch.cuda.max_memory_allocated`` of every card, in card
    order."""
    return [torch.cuda.max_memory_allocated(i) for i in cuda_cards()]

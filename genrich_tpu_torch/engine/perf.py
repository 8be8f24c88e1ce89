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

    The engine sets ``self.device`` (a ``torch.device``).
    """

    def begin_run(self) -> None:
        """Reset the per-analysis accounting."""
        self.perf = {"upload_bytes": 0, "upload_n": 0,
                     "upload_s": 0.0, "dispatch_n": 0,
                     "dispatch_s": 0.0, "fetch_n": 0, "fetch_s": 0.0,
                     "peak_fetch_s": 0.0, "peak_write_s": 0.0}

    def _put(self, arr):
        """Host array -> device tensor, accounted."""
        t0 = time.perf_counter()
        out = torch.as_tensor(np.ascontiguousarray(arr),
                              device=self.device)
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
        """Several device tensors -> numpy, counted as one fetch.

        The first ``.cpu()`` waits for the stream; the rest copy data
        that is already there.
        """
        t0 = time.perf_counter()
        out = tuple(x.cpu().numpy() for x in xs)
        p = self.perf
        p["fetch_n"] += 1
        p["fetch_s"] += time.perf_counter() - t0
        return out

"""Per-analysis device-path accounting (twin of engine/perf.py).

The same ``perf`` keys as the JAX engines: bytes, count and host wall
of host->device uploads, count and host wall of kernel/program
submissions (asynchronous on the card: ``dispatch_s`` is the host's
enqueue time), and count and wall of blocking device->host pulls.
Every host sync the engine makes (``.item()``, ``.cpu()``,
boolean-mask reads) goes through ``_fetch``/``_fetch_many`` so that
``fetch_n`` counts it; ``fetch_s`` is the wait for the card
(``fetch_wait_s``) plus the copy.  ``cast_s`` is the host's
narrowing of the events into their staging slots before the upload
(``engine/staging.py``), ``qvalue_merge_s`` the host BH merge of the
distinct p-values.  The peak stage's host seconds
split into ``peak_fetch_s`` (the engine's ``peaks_fetch``: the wait for
the device, and on the sharded engine its boundary merge,
``peak_merge_s``) and ``peak_write_s`` (the narrowPeak writer).
With several replicates, ``archive_s`` is the host seconds of the
replicate archive (``archive_replicate``, span ``pipeline.archive``)
and ``fisher_s`` those of Fisher's combination (``finalize_fisher``,
span ``pipeline.fisher``); both are parents of the dispatch and fetch
spans inside them, not further leaves.  ``archive_rows`` counts the
p-value runs the archive keeps and ``fisher_rows`` the lanes K3
combines (the merged width, every replicate's kept runs), each summed
over device chromosomes; all four stay 0 with one replicate.

Each of these host seconds is taken by ``span``, which also names the
block in any ``torch.profiler`` trace of the port (``pipeline.*``).

torch is imported where it is used: ``pipeline.py`` imports this module
on the exact engine's path too, which never loads torch.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import numpy as np


class span:
    """``with span(name, perf, key):`` adds the block's host seconds
    (``time.perf_counter``) to ``perf[key]`` and keeps them in
    ``seconds``; ``perf`` None or ``key`` None adds nothing.  While
    torch's profiler records, the block is also a
    ``torch.profiler.record_function(name)``, so that the trace holds it
    on the clock of the device records; without a profiler it enters
    none, and never records a CUDA event or synchronises.  ``name``
    None times the block only."""

    __slots__ = ("name", "perf", "key", "seconds", "_rf", "_t0")

    def __init__(self, name, perf=None, key=None):
        self.name = name
        self.perf = perf
        self.key = key
        self.seconds = 0.0

    def __enter__(self):
        self._rf = None
        torch = sys.modules.get("torch")
        if self.name is not None and torch is not None \
                and torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.perf is not None and self.key is not None:
            self.perf[self.key] = self.perf.get(self.key, 0.0) + self.seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def program_name(fn) -> str:
    """A tensor program's name for its dispatch span: its ``__name__``,
    through ``functools.partial``, without leading underscores."""
    while isinstance(fn, partial):
        fn = fn.func
    return fn.__name__.lstrip("_")


def _wait(device) -> None:
    """Block until ``device``'s current stream is done (a CUDA device;
    nothing on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.current_stream(device).synchronize()


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
                     "fetch_wait_s": 0.0, "cast_s": 0.0,
                     "qvalue_merge_s": 0.0,
                     "peak_fetch_s": 0.0, "peak_write_s": 0.0,
                     "archive_s": 0.0, "fisher_s": 0.0,
                     "archive_rows": 0, "fisher_rows": 0}

    def _put(self, arr, device=None):
        """Host array -> tensor on ``device`` (``self.device`` by
        default), accounted."""
        import torch
        p = self.perf
        with span("pipeline.upload", p, "upload_s"):
            out = torch.as_tensor(np.ascontiguousarray(arr),
                                  device=self.device if device is None
                                  else device)
        p["upload_n"] += 1
        p["upload_bytes"] += getattr(arr, "nbytes", 0)
        return out

    def _call(self, fn, *args, **kw):
        """Run a tensor program, accounted (asynchronous on the card)."""
        return self._dispatch(fn, 1, fn, *args, **kw)

    def _dispatch(self, program, n: int, run, /, *args, **kw):
        """``run(*args, **kw)``, accounted as ``n`` dispatches of
        ``program`` (its span ``pipeline.dispatch.<name>``)."""
        p = self.perf
        with span("pipeline.dispatch." + program_name(program), p,
                  "dispatch_s"):
            out = run(*args, **kw)
        p["dispatch_n"] += n
        return out

    def _fetch(self, x):
        """Device tensor -> numpy (blocking), accounted."""
        return self._fetch_many((x,))[0]

    def _fetch_many(self, xs):
        """Several device tensors -> numpy, counted as one fetch a device
        they lie on.

        Each device's stream is waited for when its first tensor
        arrives (``fetch_wait_s``); the copies follow once every tensor
        has.  ``xs`` may be a generator: what it runs to make its
        tensors (selections, collectives) counts in ``fetch_s``, with
        neither the wait nor the copy.
        """
        p = self.perf
        t0 = time.perf_counter()
        got, devices = [], set()
        for x in xs:
            if x.device not in devices:
                devices.add(x.device)
                with span("pipeline.fetch.wait", p, "fetch_wait_s"):
                    _wait(x.device)
            got.append(x)
        with span("pipeline.fetch.copy"):
            out = tuple(x.cpu().numpy() for x in got)
        p["fetch_n"] += max(len(devices), 1)
        p["fetch_s"] += time.perf_counter() - t0
        return out


def cuda_cards() -> range:
    """The indices of the CUDA cards this process sees (none without
    CUDA)."""
    import torch
    return range(torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)


def synchronize_cards() -> None:
    """Wait for every card this process sees, not only the current
    one (``torch.cuda.synchronize()`` waits for one device)."""
    import torch
    for i in cuda_cards():
        torch.cuda.synchronize(i)


def reset_peak_memory() -> None:
    """Reset the peak-memory statistics of every card."""
    import torch
    for i in cuda_cards():
        torch.cuda.reset_peak_memory_stats(i)


def peak_memory() -> list:
    """``torch.cuda.max_memory_allocated`` of every card, in card
    order."""
    import torch
    return [torch.cuda.max_memory_allocated(i) for i in cuda_cards()]

"""The traced run's readings: the profiler's device records, and the
calls of the hand kernels' entries with the shapes of their inputs.

``reduce`` turns a window's trace into what the metric readers read:
the window's length and the time in which any kernel, copy or memset
ran on the card (their union), the device time of each hand kernel
(K1-K5, found by their names in ``kernels/``) and of everything else,
the work of each recorded hand-kernel call (``kernels/<kernel>.py``),
and the breakdown: the device operations that took the most time, and
the card's idle time by the harness span the host was in.
"""

from __future__ import annotations

import contextlib
import importlib
import re

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HARNESS = ("portbench.", "pipeline.")       # the harness's span names
TOP = 10


def is_kernel(name: str, ident: str) -> bool:
    """Whether a device kernel's (demangled or mangled) ``name`` is the
    function ``ident``."""
    return f"{len(ident)}{ident}" in name or re.search(
        rf"(?<!\w){ident}(?!\w)", name) is not None


@contextlib.contextmanager
def recording(kernel, calls):
    """While the block runs, each call of ``kernel.ENTRY`` (module,
    function) appends ``kernel.record(*args)`` to ``calls``.  Without
    the entry nothing is recorded."""
    mod_name, fn_name = kernel.ENTRY
    try:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name)
    except (ImportError, AttributeError):
        yield
        return

    def wrapped(*args, **kw):
        calls.append(kernel.record(*args, **kw))
        return real(*args, **kw)
    setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        setattr(mod, fn_name, real)


@contextlib.contextmanager
def profiler():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    return res.events() if res is not None else []


def _union(iv):
    """Total length and the merged intervals of (start, end) pairs."""
    if not len(iv):
        return 0, np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > end[:-1]
    starts = iv[new, 0]
    ends = end[np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)]
    merged = np.stack([starts, ends], 1)
    return int((ends - starts).sum()), merged


def _kind(e):
    """An event's activity type ("user_annotation", "kernel",
    "gpu_memcpy", ...), from the event where PyTorch gives it, else
    from its device and name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    ours = name.startswith(HARNESS)
    if "CUDA" not in str(e.device_type()):
        return "user_annotation" if ours else "cpu_op"
    if ours:
        return "gpu_user_annotation"
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" \
        if name.startswith("Memset") else "kernel"


def _range(e):
    start = e.start_ns()
    end = getattr(e, "end_ns", None)
    return start, end() if end is not None else start + e.duration_ns()


def reduce(prof, kernels, calls, n_analyses):
    """The window's device readings (None when the profiler recorded no
    device activity)."""
    spans, dev = [], []
    window = None
    for e in _events(prof):
        kind = _kind(e)
        if kind == "user_annotation":
            if e.name() == "portbench.window":
                window = _range(e)
            elif e.name().startswith(HARNESS):
                spans.append((*_range(e), e.name()))
        elif kind in DEVICE_KINDS:
            dev.append((*_range(e), e.name()))
    if window is None or not dev:
        return None
    w0, w1 = window
    iv = np.array([(max(s, w0), min(t, w1)) for s, t, _ in dev
                   if t > w0 and s < w1], np.int64).reshape(-1, 2)
    busy, merged = _union(iv)
    by_name = {}
    for s, t, name in dev:
        d = by_name.setdefault(name, [0, 0])
        d[0] += t - s
        d[1] += 1
    hand = {}
    for k in kernels:
        ns = n = 0
        for name, (d, c) in by_name.items():
            if any(is_kernel(name, ident) for ident in k.DEVICE_NAMES):
                ns += d
                n += c
        hand[k.NAME] = {"device_ns": ns, "records": n,
                        "calls": len(calls[k.NAME]),
                        "per_call": len(k.DEVICE_NAMES),
                        "work": [k.work(c) for c in calls[k.NAME]]}
    hand_names = {name for name in by_name for k in kernels
                  if any(is_kernel(name, i) for i in k.DEVICE_NAMES)}
    staging = ("HtoD", "DtoH")
    ops_ns = sum(d for name, (d, _) in by_name.items()
                 if name not in hand_names
                 and not any(s in name for s in staging))
    # idle gaps, each named by the innermost harness span around its
    # middle ("window" outside every analysis)
    gaps = np.stack([np.append(w0, merged[:, 1]),
                     np.append(merged[:, 0], w1)], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    owner = np.full(len(gaps), -1)
    width = np.full(len(gaps), np.iinfo(np.int64).max)
    for j, (s, t, _) in enumerate(spans):
        m = (mid >= s) & (mid < t) & (t - s < width)
        owner[m] = j
        width[m] = t - s
    idle = {}
    for g, o in zip(gaps[:, 1] - gaps[:, 0], owner):
        name = spans[o][2] if o >= 0 else "portbench.window"
        idle[name] = idle.get(name, 0) + int(g)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "ops_ns": ops_ns, "hand": hand, "analyses": n_analyses,
            "breakdown": {
                "device_ops": [[name[:160], d / 1e9]
                               for name, (d, _) in top_ops],
                "idle_gaps": [[name, ns / 1e9] for name, ns in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:TOP]]}}

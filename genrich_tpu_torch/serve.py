"""Persistent-process server of the port (twin of genrich_tpu/serve.py).

``python -m genrich_tpu_torch --serve [default flags] [--device D]``
keeps one process, and one device engine per kind, across analyses:
the CUDA kernels are built and loaded once, and the native ingest
library is found once.

  - reads one analysis per line from stdin: a Genrich argument string
    (e.g. ``-t in.bam -o out.np --engine sharded -r -q 0.05``), after
    the default flags given on the command line;
  - runs it with the cached engine of its ``--engine`` kind (``jax``,
    the default: ``TorchEngine`` on one card; ``sharded``:
    ``ShardedTorchEngine``, over every card the process sees for
    ``--device cuda``, or under a process group the rank's cards), and
    calls the engine's ``release()`` after
    every analysis, which frees its tensors on every card; an
    ``--engine exact`` line runs with no engine, on the host, as
    ``genrich_tpu/serve.py`` runs it;
  - prints one status line per analysis to stdout:
      ``OK <wall_seconds> [<perf_json>]``  or  ``ERR <wall_seconds>``
    (stderr carries the usual -v output and the error), and ``READY``
    at startup.  The JSON holds the analysis's stage walls
    (``ingest_s``, ``device_rep_s``, ``findpeaks_s``) and the engine's
    upload/dispatch/fetch accounting, on a card also the analysis's
    peak device memory of each card the engine spans
    (``max_memory_allocated_by_card``, bytes, in its device order) and
    their maximum (``max_memory_allocated``); a device line's also has
    the analysis's hand-kernel launches per card index
    (``launches_by_card``, ``kernels.CARD_LAUNCHES``: empty on the CPU,
    where the wrappers run their plain versions); an exact line's has
    the walls ``ingest_s`` and ``findpeaks_s`` only.  Split the line on
    the first two whitespace fields only.

An empty line or ``EXIT`` ends the loop.  A failing analysis, an
unexpected exception included, answers ``ERR`` and serving goes on.
``--device cuda`` without a card is an error before ``READY``.  A
process group that a sharded engine joined from the environment is
left when the loop ends (``parallel.distributed.scoped_group``).
"""

from __future__ import annotations

import json
import shlex
import sys
import time
from typing import List, Optional

import torch

from . import kernels
from .cli import make_engine, native_ingest, parse_port_args
from .engine.torch_bridge import check_device
from .errors import GenrichError
from .parallel.distributed import scoped_group


def serve_loop(default_args: Optional[List[str]] = None, stdin=None,
               stdout=None, device: str = "cuda") -> int:
    """Run analyses from stdin lines until EOF/EXIT; engines persist."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    default_args = default_args or []
    try:
        dev = check_device(device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"Error! {e}\n")
        return 1
    with scoped_group():
        _serve(default_args, stdin, stdout, device, dev)
    return 0


def _serve(default_args: List[str], stdin, stdout, device: str,
           dev: torch.device) -> None:
    """The loop of ``serve_loop``; its engines live in this frame only,
    so that a process group they joined has no holder left when it
    ends."""
    engines = {}

    from .pipeline import run

    print("READY", file=stdout, flush=True)
    for line in stdin:
        line = line.strip()
        if not line or line == "EXIT":
            break
        t0 = time.perf_counter()
        try:
            p = parse_port_args(default_args + shlex.split(line))
            if p.engine not in engines:
                engines[p.engine] = make_engine(p.engine, device)
            eng = engines[p.engine]          # None for --engine exact
            native_ingest(p)
            perf: dict = {}
            on_card = eng is not None and dev.type == "cuda"
            cards = getattr(eng, "devices", [getattr(eng, "device", dev)])
            if on_card:
                for d in cards:
                    torch.cuda.reset_peak_memory_stats(d)
            kernels.reset_launches()
            try:
                run(p, engine=eng, perf=perf)
            finally:
                if eng is not None:
                    eng.release()    # per-run state; kernels stay loaded
            if on_card:
                mem = [torch.cuda.max_memory_allocated(d) for d in cards]
                perf["max_memory_allocated_by_card"] = mem
                perf["max_memory_allocated"] = max(mem)
            if eng is not None:
                perf["launches_by_card"] = {
                    i: dict(c) for i, c in kernels.CARD_LAUNCHES.items()}
            msg = f"OK {time.perf_counter() - t0:.3f}"
            if perf:
                msg += " " + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in perf.items()}, sort_keys=True)
            print(msg, file=stdout, flush=True)
        except GenrichError as e:
            sys.stderr.write(e.render() + "\n")
            print(f"ERR {time.perf_counter() - t0:.3f}", file=stdout,
                  flush=True)
        except Exception:
            # an unexpected failure must not kill the server (a client
            # mid-protocol would hang until its timeout): report it and
            # keep serving; the engine was released above
            import traceback
            traceback.print_exc()
            print(f"ERR {time.perf_counter() - t0:.3f}", file=stdout,
                  flush=True)

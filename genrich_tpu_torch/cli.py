"""Command line of the port: Genrich flags plus ``--device cuda|cpu``.

    python -m genrich_tpu_torch -t in.bam -o out.narrowPeak [flags]
        [--device cuda|cpu]

Flags are parsed by ``genrich_tpu.params.parse_args``; the analysis is
``genrich_tpu.pipeline.run`` with a ``TorchEngine`` on the chosen
device (default ``cuda``; no card is an error, never a silent switch to
the CPU).  ``p.engine`` is set to "jax" so that the pipeline takes its
device-engine branch (pipeline.py:856-869) with the engine it is given.

Only the single-replicate peak-calling path is ported: flags that
reach another path fail with "not yet ported to genrich_tpu_torch".
Errors print ``Error! <msg>`` to stderr and exit 1.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from genrich_tpu import GENRICH_COMPAT_VERSION
from genrich_tpu.cli import USAGE
from genrich_tpu.errors import GenrichError
from genrich_tpu.params import (Params, UsageRequested, VersionRequested,
                                parse_args)

from . import __version__

DEVICES = ("cuda", "cpu")


class NotPorted(Exception):
    pass


def _split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """Strip ``--device X`` from argv; returns (device, rest)."""
    device = "cuda"
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv) or argv[i + 1] not in DEVICES:
                raise ValueError("--device takes one of: "
                                 + ", ".join(DEVICES))
            device = argv[i + 1]
            i += 2
            continue
        rest.append(argv[i])
        i += 1
    return device, rest


def _no(what: str):
    raise NotPorted(f"{what} is not yet ported to genrich_tpu_torch")


def _reject_unported(p: Params) -> None:
    """Raise NotPorted for a flag whose path is not ported yet."""
    if p.peaks_only:
        _no("-P (peak calling from a log file)")
    if not p.peaks_opt:
        _no("-X (skip peak calling)")
    if p.log_file:
        _no("-f (p/q-value log)")
    if p.pile_file:
        _no("-k (pileup log)")
    if p.in_file and len([f for f in p.in_file.split(",") if f]) > 1:
        _no("more than one -t replicate (Fisher combination)")


def main(argv: Optional[List[str]] = None,
         perf: Optional[dict] = None) -> int:
    """Run one analysis; returns the exit code.

    ``perf``, when given, is filled with the pipeline's stage walls and
    the engine's upload/dispatch/fetch accounting.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        device, rest = _split_device(argv)
        if "--serve" in rest:
            _no("--serve")
        if "--engine" in rest:
            _no("--engine (the port has one engine; choose --device)")
        params = parse_args(rest)
        _reject_unported(params)
    except UsageRequested:
        sys.stderr.write(USAGE + "  --device <str>   cuda (def.) or cpu\n")
        return 1
    except VersionRequested:
        sys.stderr.write(
            f"genrich-tpu-torch, version {__version__} "
            f"(Genrich {GENRICH_COMPAT_VERSION} compatible)\n")
        return 1
    except GenrichError as e:
        sys.stderr.write(e.render() + "\n")
        return 1
    except (NotPorted, ValueError) as e:
        sys.stderr.write(f"Error! {e}\n")
        return 1

    from genrich_tpu.pipeline import run

    from .engine.torch_bridge import TorchEngine
    try:
        engine = TorchEngine(device)
    except RuntimeError as e:
        sys.stderr.write(f"Error! {e}\n")
        return 1
    params.engine = "jax"
    try:
        run(params, engine=engine, perf=perf)
    except GenrichError as e:
        sys.stderr.write(e.render() + "\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

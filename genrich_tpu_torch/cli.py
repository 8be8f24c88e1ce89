"""Command line of the port: Genrich flags plus ``--device cuda|cpu``.

    python -m genrich_tpu_torch -t in.bam -o out.narrowPeak [flags]
        [--device cuda|cpu]

Flags are parsed by ``params.parse_args``; the analysis is
``pipeline.run`` with a ``TorchEngine`` on the chosen device (default
``cuda``; no card is an error, never a silent switch to the CPU).
Before the run, ``ingest.ensure_native()`` makes the native ingest
library load on this host (building it if the committed one does not);
if that fails, the run parses with the Python reader, as the JAX
package does, after a one-line warning.

``--serve`` and ``--engine`` are not ported and fail with "not yet
ported to genrich_tpu_torch".  Errors print ``Error! <msg>`` to stderr
and exit 1.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from . import GENRICH_COMPAT_VERSION, __version__
from .errors import GenrichError
from .params import (DEFATAC, DEFAUC, DEFMAXGAP, DEFMINLEN, DEFPVAL,
                     Params, UsageRequested, VersionRequested, parse_args)

DEVICES = ("cuda", "cpu")

USAGE = f"""Usage: genrich-tpu  -t <file>  -o <file>  [optional arguments]
Required arguments:
  -t  <file>       Input SAM/BAM file(s) for experimental sample(s)
  -o  <file>       Output peak file (in ENCODE narrowPeak format)
Optional I/O arguments:
  -c  <file>       Input SAM/BAM file(s) for control sample(s)
  -f  <file>       Output bedgraph-ish file for p/q values
  -k  <file>       Output bedgraph-ish file for pileups and p-values
  -b  <file>       Output BED file for reads/fragments/intervals
  -R  <file>       Output file for PCR duplicates (only with -r)
Filtering options:
  -r               Remove PCR duplicates
  -e  <arg>        Comma-separated list of chromosomes to exclude
  -E  <file>       Input BED file(s) of genomic regions to exclude
  -m  <int>        Minimum MAPQ to keep an alignment (def. 0)
  -s  <float>      Keep sec alns with AS >= bestAS - <float> (def. 0)
  -y               Keep unpaired alignments (def. false)
  -w  <int>        Keep unpaired alns, lengths changed to <int>
  -x               Keep unpaired alns, lengths changed to paired avg
Options for ATAC-seq:
  -j               Use ATAC-seq mode (def. false)
  -d  <int>        Expand cut sites to <int> bp (def. {DEFATAC})
  -D               Skip Tn5 adjustments of cut sites (def. false)
Options for peak-calling:
  -p  <float>      Maximum p-value (def. {float(DEFPVAL):.2f})
  -q  <float>      Maximum q-value (FDR-adjusted p-value; def. 1)
  -a  <float>      Minimum AUC for a peak (def. {float(DEFAUC):.1f})
  -l  <int>        Minimum length of a peak (def. {DEFMINLEN})
  -g  <int>        Maximum distance between signif. sites (def. {DEFMAXGAP})
Other options:
  -X               Skip peak-calling
  -P               Call peaks directly from a log file (-f)
  -z               Option to gzip-compress output(s)
  -v               Option to print status updates/counts to stderr
"""


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


def _native_ingest(p: Params) -> None:
    """Make native ingest load, or warn that the Python reader runs."""
    if p.ingest == "python":
        return
    from .ingest import ensure_native
    try:
        ensure_native()
    except (OSError, RuntimeError) as e:
        reason = " ".join(str(e).split())[:200]
        sys.stderr.write(f"Warning! native ingest unavailable ({reason}); "
                         f"using the Python reader\n")


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

    from .engine.torch_bridge import TorchEngine
    from .pipeline import run
    try:
        engine = TorchEngine(device)
    except RuntimeError as e:
        sys.stderr.write(f"Error! {e}\n")
        return 1
    _native_ingest(params)
    try:
        run(params, engine=engine, perf=perf)
    except GenrichError as e:
        sys.stderr.write(e.render() + "\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

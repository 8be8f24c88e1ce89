"""Command line of the port: Genrich flags plus ``--device cuda|cpu``.

    python -m genrich_tpu_torch -t in.bam -o out.narrowPeak [flags]
        [--engine jax|sharded|exact] [--device cuda|cpu]
    python -m genrich_tpu_torch --serve [default flags] [--device cuda|cpu]

Flags are parsed by ``params.parse_args``; the analysis is
``pipeline.run`` with a device engine on the chosen device (default
``cuda``; no card is an error, never a silent switch to the CPU).
``--engine jax`` selects ``TorchEngine``, ``--engine sharded`` the
tile-sharded ``ShardedTorchEngine``: over every card the process sees
for ``--device cuda`` (``CUDA_VISIBLE_DEVICES`` restricts them;
``--device cuda:i`` pins one), or over the ranks of a
``torch.distributed`` group joined from ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``, each with its own cards: for ``--device cuda``
the rank's share of the host's cards when torchrun's
``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` are set (``LOCAL_WORLD_SIZE=1``:
every card the process sees, the JAX package's one process a host),
else the card ``RANK`` modulo the host's; the names are the JAX
package's, so its argument strings run unchanged.  The port's default engine is ``jax``;
the JAX package's (the ``Params`` default) is ``exact``.  ``--engine
exact`` is the host engine by name, as in the JAX package:
``pipeline.run`` with no device engine, numpy on the host with C-exact
semantics; it touches no CUDA API and ignores ``--device``.
``--serve`` runs ``serve.serve_loop``: one analysis per stdin line,
with one engine per kind kept across them.

Before a run, ``ingest.ensure_native()`` makes the native ingest
library load on this host (building it if the committed one does not);
if that fails, the run parses with the Python reader, as the JAX
package does, after a one-line warning.  Errors print ``Error! <msg>``
to stderr and exit 1.
"""

from __future__ import annotations

import contextlib
import re
import sys
from typing import List, Optional, Tuple

from . import GENRICH_COMPAT_VERSION, __version__
from .errors import GenrichError
from .params import (DEFATAC, DEFAUC, DEFMAXGAP, DEFMINLEN, DEFPVAL,
                     Params, UsageRequested, VersionRequested, parse_args)

DEVICES = ("cuda", "cpu")       # and "cuda:<index>"

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


EXTRA_USAGE = """Options of the PyTorch port:
  --device <str>   cuda (def.; sharded: every visible card, or a
                     torch.distributed rank's share of them), cuda:<i>
                     or cpu; not read by --engine exact
  --engine <str>   jax (def.; one tensor per chromosome), sharded
                     (tiles over the cards; with MASTER_ADDR,
                     MASTER_PORT, WORLD_SIZE, RANK over the ranks of a
                     torch.distributed group, each rank's cards
                     device_count / LOCAL_WORLD_SIZE from LOCAL_RANK
                     when those are set, else card RANK modulo the
                     host's) or exact (the host engine: numpy, no
                     device)
  --serve          One analysis per stdin line (READY; OK/ERR per line)
"""


def _split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """Strip ``--device X`` from argv; returns (device, rest)."""
    device = "cuda"
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv) or not (
                    argv[i + 1] in DEVICES
                    or re.fullmatch(r"cuda:\d+", argv[i + 1])):
                raise ValueError("--device takes one of: "
                                 + ", ".join(DEVICES) + ", cuda:<index>")
            device = argv[i + 1]
            i += 2
            continue
        rest.append(argv[i])
        i += 1
    return device, rest


def parse_port_args(argv: List[str]) -> Params:
    """``parse_args`` with the port's default engine, ``jax`` (the
    ``Params`` default, ``exact``, is the JAX package's); a later
    ``--engine`` wins."""
    return parse_args(["--engine", "jax"] + argv)


def make_engine(kind: str, device: str):
    """A device engine of ``kind`` ("jax" or "sharded") on ``device``;
    None for "exact", the host engine."""
    if kind == "exact":
        return None
    if kind == "sharded":
        from .engine.sharded_bridge import ShardedTorchEngine
        return ShardedTorchEngine(device)
    from .engine.torch_bridge import TorchEngine
    return TorchEngine(device)


def native_ingest(p: Params) -> None:
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
            from .serve import serve_loop
            return serve_loop([a for a in rest if a != "--serve"],
                              device=device)
        params = parse_port_args(rest)
    except UsageRequested:
        sys.stderr.write(USAGE + EXTRA_USAGE)
        return 1
    except VersionRequested:
        sys.stderr.write(
            f"genrich-tpu-torch, version {__version__} "
            f"(Genrich {GENRICH_COMPAT_VERSION} compatible)\n")
        return 1
    except GenrichError as e:
        sys.stderr.write(e.render() + "\n")
        return 1
    except ValueError as e:
        sys.stderr.write(f"Error! {e}\n")
        return 1

    scope = contextlib.nullcontext()
    if params.engine != "exact":     # the host engine loads no torch
        from .parallel.distributed import scoped_group
        scope = scoped_group()
    try:
        with scope:
            _analyse(params, device, perf)
    except GenrichError as e:
        sys.stderr.write(e.render() + "\n")
        return 1
    except ValueError as e:          # no engine, or a flag it cannot honour
        sys.stderr.write(f"Error! {e}\n")
        return 1
    return 0


def _analyse(params: Params, device: str, perf: Optional[dict]) -> None:
    """``pipeline.run`` of ``params`` with an engine of its kind on
    ``device``; an engine that cannot be made raises ValueError.  The
    engine lives in this frame only, so that a process group it joined
    has no holder left when the call ends (``scoped_group``)."""
    from .pipeline import run
    try:
        engine = make_engine(params.engine, device)
    except RuntimeError as e:
        raise ValueError(str(e)) from e
    native_ingest(params)
    run(params, engine=engine, perf=perf)


if __name__ == "__main__":
    sys.exit(main())

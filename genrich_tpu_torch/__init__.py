"""genrich_tpu_torch: the PyTorch/CUDA port of genrich-tpu.

The peak-calling paths of ``genrich_tpu``'s device engines (``--engine
jax`` and ``sharded``: one or several ``-t`` replicates, the
``-f``/``-k`` logs, ``-X``/``-P``, ``--serve``) run here on one NVIDIA
Hopper card through hand-written CUDA kernels
(``genrich_tpu_torch/csrc``), or on the CPU through their plain PyTorch
versions; ``--engine exact`` runs the host engine in numpy, as the JAX
package does.  The package stands alone: it imports ``torch`` and never
``jax`` nor ``genrich_tpu``, and keeps its own copy of the host half
(ingest, params, the exact engine, the writers, ``tools/find_ns``).

Layout mirrors ``genrich_tpu``, so each module's counterpart has the
same path there: ``errors``, ``params``, ``io/``, ``ingest/`` (with the
native library's build in ``ingest/native.py``), ``output/``,
``logreader``, ``utils/``, ``tools/``, ``pipeline`` and the host modules
of ``engine/`` are copies; ``ops/`` holds the
tensor programs (each with its JAX twin named in its docstring),
``engine/torch_bridge.py`` the device engine that ``pipeline.run``
drives, ``kernels.py`` the nvcc build, ctypes binding and launch
counters, ``prof.py`` a device-time profile of the main and Fisher
paths, ``testing.py`` helpers of the tests and chip_smoke.py.
"""

__version__ = "0.1.0"

# Keep genome-scale numpy temporaries on the persistent heap instead
# of per-allocation mmap/munmap (see utils/malloc_tuning.py), as the
# JAX package does, so the two packages' ingest walls compare.
import os as _os

if _os.environ.get("GENRICH_MALLOC_TUNING", "1") != "0":
    from .utils.malloc_tuning import tune_malloc as _tune_malloc

    _tune_malloc()

GENRICH_COMPAT_VERSION = "0.6.2"  # reference Genrich.h:9

"""genrich_tpu_torch: the PyTorch/CUDA port of genrich-tpu's device path.

The peak-calling path of ``genrich_tpu``'s ``--engine jax`` (one or
several ``-t`` replicates, the ``-f``/``-k`` logs, ``-X``/``-P``) runs
here on one NVIDIA Hopper card through hand-written CUDA kernels
(``genrich_tpu_torch/csrc``), or on the CPU through their plain PyTorch
versions.  Host-side work (ingest, BH q-value sweep, output writers,
the exact-engine fallback for >2^31-bp chromosomes) is imported from
``genrich_tpu``, never copied; this package imports ``torch`` and never
``jax``.

Layout mirrors ``genrich_tpu``: ``ops/`` holds the tensor programs
(each with its JAX twin named in its docstring), ``engine/`` the
device engine that ``genrich_tpu.pipeline.run`` drives, ``kernels.py``
the nvcc build, ctypes binding and launch counters, ``ingest.py`` the
native ingest build, ``prof.py`` a device-time profile of the main and
Fisher paths, ``testing.py`` helpers of the tests and chip_smoke.py.
"""

__version__ = "0.1.0"

"""The benchmark of genrich_tpu_torch on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json``.  What belongs to one configuration, traffic mix,
metric or hand kernel is a file of its own: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``,
``kernels/<kernel>.py``.  ``reference/`` is the plain reference that
decides ``correct``; it imports nothing of the program.  Nothing here
imports JAX or the JAX package.
"""

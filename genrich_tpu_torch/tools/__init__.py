"""Accessory tools of the port: copies of ``genrich_tpu/tools`` and of
``scripts/perf_synth.py``, the benchmark's BAM maker."""

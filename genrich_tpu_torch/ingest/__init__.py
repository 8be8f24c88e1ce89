"""Host ingest: SAM/BAM records to per-chromosome fragment events.

``ensure_native()`` loads the port's C++ ingest library (``native.py``)
before a run, building ``genrich_tpu_torch/native/ingest.cpp`` at first
use.
"""

from .native import ensure_native

__all__ = ["ensure_native"]

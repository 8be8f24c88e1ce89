"""Tensor programs of the device path (PyTorch twins of genrich_tpu.ops)."""

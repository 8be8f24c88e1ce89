"""The plain reference of a Genrich analysis (plain PyTorch and numpy)
and the comparison that decides a run's ``correct``.  Imports nothing
of genrich_tpu_torch, genrich_tpu or JAX."""

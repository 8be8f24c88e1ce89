"""Tile sharding of the genome over torch.distributed ranks (twin of
genrich_tpu/parallel)."""

"""Device engine driven by genrich_tpu.pipeline.run."""

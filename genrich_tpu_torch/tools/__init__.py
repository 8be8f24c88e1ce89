"""Accessory tools of the port (copies of ``genrich_tpu/tools``)."""

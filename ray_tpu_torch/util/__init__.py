"""Utilities of the port (``ray_tpu/util`` on one device)."""

"""Internals of ``ray_tpu_torch.train``."""

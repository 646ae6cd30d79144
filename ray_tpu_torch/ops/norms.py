"""Normalization ops (port of ``ray_tpu/ops/norms.py``).

RMSNorm stays plain PyTorch, as the JAX package deliberately keeps it plain
jnp: the op is bandwidth-bound and small beside the matmuls around it.  A
fused kernel is a later performance item, not part of the port.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, computed in fp32 for stability."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)

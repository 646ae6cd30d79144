"""Tensor ops of the port: plain PyTorch ops and hand-written CUDA kernels."""

from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "apply_rope",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "rms_norm",
    "rope_frequencies",
]

"""Tensor ops of the port: plain PyTorch ops and hand-written CUDA kernels."""

from ray_tpu_torch.ops.attention import (
    multi_head_attention,
    reference_attention,
)
from ray_tpu_torch.ops.grouped_matmul import gmm, tgmm
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "apply_rope",
    "gmm",
    "multi_head_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "reference_attention",
    "rms_norm",
    "rope_frequencies",
    "tgmm",
]

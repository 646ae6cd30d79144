"""Rotary position embeddings (RoPE), Llama-3 style.

Port of ``ray_tpu/ops/rope.py``.  The frequency table is computed on the
host in float64 with numpy, exactly as the JAX package does, so both
packages start from bit-identical cos/sin tables; the engine moves them to
its device once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    max_seq_len: int,
    theta: float = 500000.0,
    scaling: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin), each [max_seq_len, head_dim // 2], float32.

    ``scaling`` optionally applies Llama-3.1-style NTK frequency scaling:
    {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position": 8192}.
    """
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling:
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig = scaling["original_max_position"]
        wavelen = 2 * np.pi / inv_freq
        # three bands: leave high-freq alone, divide low-freq by factor,
        # smoothly interpolate between.
        smooth = (orig / wavelen - low) / (high - low)
        smooth = np.clip(smooth, 0.0, 1.0)
        scaled = inv_freq / factor
        inv_freq = np.where(
            wavelen < orig / high,
            inv_freq,
            np.where(wavelen > orig / low, scaled, (1 - smooth) * scaled + smooth * inv_freq),
        )
    t = np.arange(max_seq_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by position-dependent angles.

    x: [batch, seq, heads, head_dim]. cos/sin: [max_seq, head_dim/2] fp32.
    ``positions`` [batch, seq] (or [1, seq]) gathers per-batch rows; every
    position must lie inside the table (torch raises where JAX would fill).
    Split-half convention (the neox/llama weight layout); computed in fp32
    and cast back to x's dtype.
    """
    if positions is not None:
        cos = cos[positions]  # [B, S, half]
        sin = sin[positions]
    else:
        seq = x.shape[1]
        cos = cos[:seq]
        sin = sin[:seq]
    if cos.dim() == 2:  # [S, half]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # [B, S, half]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)

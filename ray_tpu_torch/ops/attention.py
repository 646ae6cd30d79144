"""Attention ops: GQA scaled-dot-product attention (port of
``ray_tpu/ops/attention.py``).

Two paths behind one API:
  - the plain reference (any device; logits materialised, softmax in fp32),
  - the flash kernels (``ray_tpu_torch.ops.flash_attention``), selected
    automatically on a CUDA device for the shapes the JAX package sends to
    its TPU kernel.

``use_flash=True`` on a CUDA tensor the kernels cannot take raises
``ValueError`` with the reason: the card never gives way to the reference
unasked.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (
    INSTANTIATIONS,
    flash_attention,
    instantiation,
)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D] for grouped-query attention."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D].

    Logits in fp32 from the input-dtype operands, masked to -1e30; softmax
    in fp32, rounded to v's dtype for the PV product.  Supports GQA (Hq a
    multiple of Hkv) and segment masking (tokens attend only within equal
    segment ids)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        # query i (at absolute position skv - sq + i) sees keys <= that position
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = qpos >= kpos
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]  # [B, Sq, Skv]
        seg = seg[:, None, :, :]
        mask = seg if mask is None else (mask[None, None] & seg)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_refusal(q, k, v, segment_ids=None) -> Optional[str]:
    """Why the flash kernels cannot take this call, or None when they can.
    Anywhere: no segment ids, Sq == Skv.  On a CUDA device also the JAX
    package's TPU gate (S and D multiples of 128), inputs of one dtype and a
    built instantiation of (dtype, D)."""
    if segment_ids is not None:
        return "flash attention takes no segment_ids"
    if q.shape[1] != k.shape[1]:
        return f"flash attention needs Sq == Skv (got {q.shape[1]}, {k.shape[1]})"
    if q.device.type != "cuda":
        return None
    if q.shape[1] % 128 or q.shape[-1] % 128:
        return (f"the flash kernels are gated to S and D multiples of 128 "
                f"(got S={q.shape[1]}, D={q.shape[-1]})")
    for t in (k, v):
        if t.dtype != q.dtype:
            return (f"the flash kernels take q, k and v of one dtype (got "
                    f"{q.dtype}, {k.dtype}, {v.dtype})")
    return _instantiation_refusal(q.dtype, q.shape[-1])


def _instantiation_refusal(dtype, head_dim) -> Optional[str]:
    if instantiation(dtype, head_dim) is not None:
        return None
    built = ", ".join(f"{str(t).replace('torch.', '')} at head_dim {d}"
                      for t, d in INSTANTIATIONS)
    return (f"no flash kernel is built for {dtype} at head_dim {head_dim} "
            f"(built: {built})")


def flash_config_refusal(cfg, device) -> Optional[str]:
    """Why a model config would reach a flash kernel that is not built on
    ``device``, or None when it cannot.  From the config alone: on a CUDA
    device the gate below sends any head_dim that is a multiple of 128 to
    the flash kernels (at sequences that are multiples of 128), which are
    built for ``flash_attention.INSTANTIATIONS`` (bf16 and fp32 at head_dim
    128 and 256, as the presets reach; none reaches 384 or more)."""
    if torch.device(device).type != "cuda" or cfg.head_dim % 128:
        return None
    why = _instantiation_refusal(cfg.compute_dtype, cfg.head_dim)
    if why:
        return (f"on CUDA the attention gate sends this config to the flash "
                f"kernels: {why}")
    return None


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         use_flash: Optional[bool] = None,
                         block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """GQA attention, auto-selecting the flash kernels on a CUDA device.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]. Returns [B, Sq, Hq, D].
    ``use_flash`` None applies the JAX package's gate (with a CUDA device
    in place of the TPU backend); True forces the flash path and raises
    where it cannot run; False forces the reference."""
    if use_flash is None:
        use_flash = (
            q.device.type == "cuda"
            and segment_ids is None
            and q.shape[1] == k.shape[1]
            and q.shape[1] % 128 == 0
            and q.shape[-1] % 128 == 0
        )
    if use_flash:
        why = flash_refusal(q, k, v, segment_ids)
        if why:
            raise ValueError(f"multi_head_attention(use_flash=True): {why}")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    return reference_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               scale=scale)

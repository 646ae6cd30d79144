"""Llama-family decoder LM: the paged inference programs, in PyTorch.

Port of the paged serving part of ``ray_tpu/models/llama.py``.  The layout
stays the JAX package's, so the weight bridge (``ray_tpu_torch.convert``)
is a copy and never a transpose:
  - parameters are a dict of tensors with the layers STACKED on a leading
    axis ([L, ...]) and every projection oriented for ``x @ w``;
  - the KV pool is [L, num_blocks, block_size, kv*hd] (one page is a
    contiguous [bs, kv*hd] slab, a kv head a column slice of it);
  - products take compute-dtype operands with fp32 accumulation and a
    compute-dtype result (cuBLAS's, like XLA's); norms, rope and softmax
    run in fp32; logits come back in fp32.

The JAX programs thread the pool through ``lax.scan`` and donate it; here
the layers are a Python loop and the pool is updated IN PLACE
(``index_put_``), so a program returns the same pool dict it was given.

Not ported in this slice (see ROADMAP.md): ``forward``/``loss_fn`` (the
training step), ``prefill``/``decode_step`` (the static engine),
``decode_window_paged`` (speculative verification), and tensor
parallelism (``TPPlan``, ``mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import (
    GROUPS,
    HEAD_DIMS,
    attend_gathered,
    kernel_supports,
    paged_decode_attention,
)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = Dict[str, Any]

_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        per_layer = d * hq + 2 * d * hkv + hq * d + 3 * d * f + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.n_layers * per_layer + d + head

    # ---- presets ----
    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama32_1b(cls, **kw) -> "LlamaConfig":
        return cls(
            dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192,
            tie_embeddings=True, **kw
        )

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config: runs in milliseconds on a CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 128)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("ffn_dim", 256)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("compute_dtype", torch.float32)
        return cls(**kw)


def param_dtypes(cfg: LlamaConfig) -> Dict[str, torch.dtype]:
    """Storage dtype of each parameter.  Embedding, head and projections
    are stored in the compute dtype: the JAX programs cast each of them to
    it right before use (``w.astype(cdt)``), so storing the cast is the
    same arithmetic at half the bytes.  Norm weights keep the param dtype:
    ``rms_norm`` reads them in fp32."""
    cdt, pdt = cfg.compute_dtype, cfg.param_dtype
    out = {"embed": cdt, "lm_head": cdt, "final_norm": pdt,
           "attn_norm": pdt, "mlp_norm": pdt}
    out.update({k: cdt for k in _MATMUL_WEIGHTS})
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device) -> Params:
    """Random stacked-layers params (the JAX package's init scheme: normal
    with std 0.02, output projections scaled by 1/sqrt(2L), unit norms),
    drawn from ``generator`` on ``device``.  The numbers differ from
    ``ray_tpu``'s for the same seed; parity tests carry JAX's weights over
    with ``convert.params_from_jax`` instead."""
    d, f = cfg.dim, cfg.ffn_dim
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    dts = param_dtypes(cfg)

    def normal(name, shape, s):
        return torch.empty(shape, dtype=dts[name], device=device).normal_(
            0.0, s, generator=generator)

    def ones(name, shape):
        return torch.ones(shape, dtype=dts[name], device=device)

    params: Params = {
        "embed": normal("embed", (cfg.vocab_size, d), std),
        "layers": {
            "attn_norm": ones("attn_norm", (L, d)),
            "wq": normal("wq", (L, d, hq), std),
            "wk": normal("wk", (L, d, hkv), std),
            "wv": normal("wv", (L, d, hkv), std),
            "wo": normal("wo", (L, hq, d), out_std),
            "mlp_norm": ones("mlp_norm", (L, d)),
            "w_gate": normal("w_gate", (L, d, f), std),
            "w_up": normal("w_up", (L, d, f), std),
            "w_down": normal("w_down", (L, f, d), out_std),
        },
        "final_norm": ones("final_norm", (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal("lm_head", (d, cfg.vocab_size), std)
    return params


def rope_cache(cfg: LlamaConfig, max_seq: int, device) -> tuple:
    """(cos, sin) [max_seq, hd/2] fp32 on ``device`` (numpy float64 math,
    identical to the JAX package's tables)."""
    cos, sin = rope_frequencies(cfg.head_dim, max_seq, cfg.rope_theta)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def init_paged_kv_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                        device, dtype=None) -> Dict[str, torch.Tensor]:
    """Block-pool KV cache shared by all sequences; memory ∝ blocks in use."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, num_blocks, block_size,
             cfg.n_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_attend(cfg: LlamaConfig, q, ck, cv, span_mask):
    """GQA attention of q [B, T, nh, hd] against gathered spans ck/cv
    [B, S, kv, hd]; span_mask [B, T, S] True = visible.  [B, T, nh*hd] fp32."""
    return attend_gathered(q, ck, cv, span_mask)


def paged_kernel_refusal(cfg: LlamaConfig, device,
                         pool_dtype: Optional[torch.dtype] = None
                         ) -> Optional[str]:
    """Why the CUDA paged-attention kernel cannot serve ``cfg`` on
    ``device`` with a ``pool_dtype`` pool, or None when it can."""
    pool_dtype = pool_dtype or cfg.compute_dtype
    if torch.device(device).type != "cuda":
        return f"the kernel runs on CUDA devices only (device {device})"
    if pool_dtype != torch.bfloat16:
        return f"the kernel takes a bf16 KV pool (got {pool_dtype})"
    if (cfg.n_heads % cfg.n_kv_heads
            or not kernel_supports(cfg.head_dim,
                                   cfg.n_heads // cfg.n_kv_heads)):
        return (f"the kernel is built for head_dim in {HEAD_DIMS} and GQA "
                f"group in {GROUPS} (got head_dim {cfg.head_dim}, "
                f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads)")
    return None


def paged_kernel_supported(cfg: LlamaConfig, device,
                           pool_dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA paged-attention kernel applies: a CUDA device, a
    bf16 pool, and a head_dim and GQA group the kernel is compiled for
    (Llama-3-8B: head_dim 128, group 4)."""
    return paged_kernel_refusal(cfg, device, pool_dtype) is None


def _head(cfg: LlamaConfig, params: Params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _mlp(cfg: LlamaConfig, x, params: Params, li: int):
    lp = params["layers"]
    h = rms_norm(x, lp["mlp_norm"][li], cfg.rms_norm_eps)
    gated = F.silu(h @ lp["w_gate"][li]) * (h @ lp["w_up"][li])
    return x + gated @ lp["w_down"][li]


def _single_device(cfg: LlamaConfig, rope: Optional[tuple], device, mesh,
                   tp_plan) -> tuple:
    """The (cos, sin) tables to use; refuses what only TP serving takes."""
    if mesh is not None or tp_plan is not None:
        raise NotImplementedError(
            "mesh / tp_plan (tensor-parallel paged programs) are not ported "
            "to ray_tpu_torch yet (ROADMAP A11)")
    return rope if rope is not None else rope_cache(cfg, cfg.max_seq_len, device)


def decode_step_paged(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                      pool: Dict[str, torch.Tensor], table: torch.Tensor,
                      lengths: torch.Tensor,
                      rope_cache: Optional[tuple] = None,
                      use_kernel: bool = False, mesh=None, tp_plan=None):
    """One-token decode for every slot, KV in a paged pool.

    tokens [B] int; table [B, W] int32 block ids covering each slot's
    sequence (the host guarantees coverage through position lengths[b]);
    lengths [B] int32; rope_cache (cos, sin) from :func:`rope_cache`
    (default: built for ``cfg.max_seq_len``).  Each layer writes the new
    K/V at position lengths[b] BEFORE attending, so the span is
    lengths + 1.  ``use_kernel``: the CUDA paged-attention kernel (reads
    only each row's live pages) instead of the table gather.  ``mesh`` and
    ``tp_plan`` must be None (single device).  Returns (logits [B, V] fp32,
    pool) -- the pool is updated in place."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, mesh, tp_plan)
    b = tokens.shape[0]
    bs = pool["k"].shape[2]
    w = table.shape[1]
    hd = cfg.head_dim
    lp = params["layers"]
    bidx = torch.arange(b, device=tokens.device)
    lengths_l = lengths.long()
    # a table index past W raises here (JAX would clamp): coverage is the
    # host's guarantee, checked where it allocates
    cur_blk = table[bidx, lengths_l // bs].long()  # [B] block of the write
    cur_off = lengths_l % bs
    pos = lengths_l[:, None]
    if not use_kernel:  # the kernel masks from `lengths` itself
        span_mask = (torch.arange(w * bs, device=tokens.device)[None, None, :]
                     <= lengths_l[:, None, None])  # [B, 1, W*bs]
    x = params["embed"][tokens.long()]
    pk_all, pv_all = pool["k"], pool["v"]
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = (h @ lp["wq"][li]).view(b, 1, cfg.n_heads, hd)
        k = (h @ lp["wk"][li]).view(b, 1, cfg.n_kv_heads, hd)
        v = h @ lp["wv"][li]
        q = apply_rope(q, cos, sin, positions=pos)
        k = apply_rope(k, cos, sin, positions=pos)
        # in place (JAX donates the pool).  Inactive slots all point at the
        # sink block 0 with duplicate indices: their garbage is never read
        pk_all[li].index_put_((cur_blk, cur_off), k.reshape(b, -1).to(pk_all.dtype))
        pv_all[li].index_put_((cur_blk, cur_off), v.to(pv_all.dtype))
        if use_kernel:
            attn = paged_decode_attention(q[:, 0], pk_all, pv_all, li, table,
                                          lengths)
        else:
            idx = table.long()
            ck = pk_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
            cv = pv_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
            attn = _paged_attend(cfg, q, ck, cv, span_mask)[:, 0]
        x = x + attn.to(cfg.compute_dtype) @ lp["wo"][li]
        x = _mlp(cfg, x, params, li)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ _head(cfg, params)).float(), pool


def prefill_chunk_paged(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                        pool: Dict[str, torch.Tensor], table: torch.Tensor,
                        p0: int, rope_cache: Optional[tuple] = None,
                        tp_plan=None):
    """Prefill ONE chunk of a single sequence into its pool blocks.

    tokens [1, C] (C a multiple of block_size; tail garbage-padded -- padded
    positions write blocks the sequence owns and are masked by length
    thereafter); p0 = global position of tokens[0, 0] (a host int, a
    multiple of block_size); table [1, W] covers positions [0, p0 + C).
    Attention is causal over the whole prefix: earlier chunks' KV is read
    back from the pool.  ``tp_plan`` must be None.  Returns (logits
    [1, C, V] fp32, pool) -- the pool is updated in place."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, tp_plan)
    b, c = tokens.shape
    bs = pool["k"].shape[2]
    w = table.shape[1]
    hd = cfg.head_dim
    lp = params["layers"]
    if p0 % bs or c % bs:
        raise ValueError(f"prefill chunk p0={p0}, C={c} not block-aligned ({bs})")
    # JAX's dynamic_slice would clamp a start past the table; the table
    # width (llm/paged.py _prefill_table_width) must make that impossible
    if p0 // bs + c // bs > w:
        raise ValueError(
            f"prefill table width {w} does not cover blocks "
            f"[{p0 // bs}, {p0 // bs + c // bs})")
    chunk_blocks = table[0, p0 // bs:p0 // bs + c // bs].long()
    positions = p0 + torch.arange(c, device=tokens.device)  # [C] global
    span_mask = (torch.arange(w * bs, device=tokens.device)[None, None, :]
                 <= positions[None, :, None])  # [1, C, W*bs] causal
    # the padded tail of a final chunk may run past the rope table (JAX's
    # take fills those rows with NaN); clamp: its K lands only in positions
    # that decode overwrites before any query can see them
    rope_pos = positions.clamp(max=cos.shape[0] - 1)[None, :]
    x = params["embed"][tokens.long()]
    pk_all, pv_all = pool["k"], pool["v"]
    idx = table.long()
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = (h @ lp["wq"][li]).view(b, c, cfg.n_heads, hd)
        k = (h @ lp["wk"][li]).view(b, c, cfg.n_kv_heads, hd)
        v = h @ lp["wv"][li]
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k = apply_rope(k, cos, sin, positions=rope_pos)
        # [1, C, kv, hd] -> [C/bs, bs, kv*hd] block-major slab writes, in place
        pk_all[li].index_copy_(0, chunk_blocks,
                               k[0].reshape(c // bs, bs, -1).to(pk_all.dtype))
        pv_all[li].index_copy_(0, chunk_blocks,
                               v[0].reshape(c // bs, bs, -1).to(pv_all.dtype))
        ck = pk_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
        cv = pv_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
        attn = _paged_attend(cfg, q, ck, cv, span_mask)
        x = x + attn.to(cfg.compute_dtype) @ lp["wo"][li]
        x = _mlp(cfg, x, params, li)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ _head(cfg, params)).float(), pool

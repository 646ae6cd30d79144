"""Llama-family decoder LM in PyTorch: the training forward and loss, and
the inference programs over a static KV cache and over a paged pool.

Port of ``ray_tpu/models/llama.py``.  The layout stays the JAX package's,
so the weight bridge (``ray_tpu_torch.convert``) is a copy and never a
transpose:
  - parameters are a dict of tensors with the layers STACKED on a leading
    axis ([L, ...]) and every projection oriented for ``x @ w``;
  - the KV pool is [L, num_blocks, block_size, kv*hd] (one page is a
    contiguous [bs, kv*hd] slab, a kv head a column slice of it);
  - products take compute-dtype operands with fp32 accumulation and a
    compute-dtype result (cuBLAS's, like XLA's); norms, rope and softmax
    run in fp32; logits come back in fp32.

The JAX programs thread the pool (or the static cache) through
``lax.scan`` and donate it; here the layers are a Python loop and the pool
or cache is updated IN PLACE (``index_put_``), so a program returns the
same dict it was given.

Training (``forward``/``loss_fn``) keeps its params in ``cfg.param_dtype``
(fp32 master weights, ``train_param_dtypes``) and casts each at its
product, as the JAX ``_layer`` does; the paged programs keep their
pre-cast storage (``param_dtypes``).

Remat policies (``cfg.remat_policy``, the JAX package's three): "full"
recomputes each layer in the backward pass; "attn" keeps the flash
forward's O and LSE, so the recompute launches no forward kernel; "dots"
keeps every weight product's output (``run_layers``).

Not ported yet (see ROADMAP.md): meshes: tensor and context parallelism
(``TPPlan``, ``mesh``, ring attention; A11).
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ray_tpu_torch.ops import flash_attention as _flash
from ray_tpu_torch.ops.attention import multi_head_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import (
    BLOCK_SIZES,
    GROUPS,
    HEAD_DIMS,
    attend_gathered,
    block_size_supported,
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
    remat: bool = True
    # what the per-layer checkpoint keeps for the backward pass:
    #   "full" — nothing: one extra forward of recompute
    #   "attn" — the flash forward's O and LSE: the recompute skips the
    #            forward kernel (+B*S*D bf16 and B*H*S fp32 per layer)
    #   "dots" — every weight product's output (the JAX package's
    #            dots_with_no_batch_dims_saveable)
    remat_policy: str = "full"

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
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        """Meta's Llama-3-70B shapes.  A config only: its 70.6 B params do
        not fit one 80 GB card in bf16."""
        return cls(
            dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672, **kw
        )

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


def train_param_dtypes(cfg: LlamaConfig) -> Dict[str, torch.dtype]:
    """Storage dtype of each parameter for training: ``cfg.param_dtype``
    throughout, as the JAX package stores them (fp32 master weights by
    default); ``forward`` casts each to the compute dtype at its use."""
    return {k: cfg.param_dtype for k in param_dtypes(cfg)}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device, dtypes: Optional[Dict[str, torch.dtype]] = None
                ) -> Params:
    """Random stacked-layers params (the JAX package's init scheme: normal
    with std 0.02, output projections scaled by 1/sqrt(2L), unit norms),
    drawn from ``generator`` on ``device`` and stored as ``dtypes`` says
    (default ``param_dtypes``: serving; ``train_param_dtypes`` for
    training).  The numbers differ from ``ray_tpu``'s for the same seed;
    parity tests carry JAX's weights over with ``convert`` instead."""
    d, f = cfg.dim, cfg.ffn_dim
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    dts = param_dtypes(cfg) if dtypes is None else dtypes

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
                         pool_dtype: Optional[torch.dtype] = None,
                         block_size: Optional[int] = None) -> Optional[str]:
    """Why the CUDA paged-attention kernel cannot serve ``cfg`` on
    ``device`` with a ``pool_dtype`` pool of ``block_size``-token pages
    (None: not checked), or None when it can."""
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
    if block_size is not None and not block_size_supported(block_size):
        return (f"the kernel takes {BLOCK_SIZES} (got block size "
                f"{block_size})")
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


def decode_window_paged(cfg: LlamaConfig, params: Params,
                        tokens: torch.Tensor, pool: Dict[str, torch.Tensor],
                        table: torch.Tensor, lengths: torch.Tensor,
                        rope_cache: Optional[tuple] = None,
                        pos_limit: Optional[int] = None, tp_plan=None):
    """Multi-token decode window for every slot (speculative verification).

    tokens [B, T]: per-slot window whose token j sits at global position
    lengths[b] + j.  Each layer writes the window's K/V into the pool at
    those positions -- positions at or past ``pos_limit`` (the engine's
    max_seq; default the table span) go to sink block 0 instead of being
    clamped onto live KV -- then attends causally over the table span by
    the table gather (window token j sees the prefix and window tokens
    <= j), as ``prefill_chunk_paged`` does.  The host guarantees table
    coverage of positions < pos_limit through lengths + T.  ``tp_plan``
    must be None.  Returns (logits [B, T, V] fp32, pool) -- the pool is
    updated in place.

    The JAX program gathers too: the paged kernel is single-query decode."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, tp_plan)
    b, t = tokens.shape
    bs = pool["k"].shape[2]
    w = table.shape[1]
    hd = cfg.head_dim
    lp = params["layers"]
    dev = tokens.device
    limit = pos_limit if pos_limit is not None else w * bs
    positions = (lengths.long()[:, None]
                 + torch.arange(t, device=dev)[None, :])  # [B, T] global
    safe = positions.clamp(max=limit - 1)  # rope-table safe
    # a column past the table clamps, as JAX's gather does: only rows the
    # host left uncovered (inactive slots, zero rows) reach it
    col = (safe // bs).clamp(max=w - 1)
    blk = torch.where(positions < limit, torch.gather(table.long(), 1, col),
                      0)  # past the limit -> sink
    off = safe % bs
    span_mask = (torch.arange(w * bs, device=dev)[None, None, :]
                 <= positions[:, :, None])  # [B, T, W*bs] causal
    x = params["embed"][tokens.long()]
    pk_all, pv_all = pool["k"], pool["v"]
    idx = table.long()
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = (h @ lp["wq"][li]).view(b, t, cfg.n_heads, hd)
        k = (h @ lp["wk"][li]).view(b, t, cfg.n_kv_heads, hd)
        v = h @ lp["wv"][li]
        q = apply_rope(q, cos, sin, positions=safe)
        k = apply_rope(k, cos, sin, positions=safe)
        # in place; duplicate sink indices collide with garbage only (no
        # row's table holds block 0 inside its live span)
        pk_all[li].index_put_((blk, off), k.reshape(b, t, -1).to(pk_all.dtype))
        pv_all[li].index_put_((blk, off), v.to(pv_all.dtype))
        ck = pk_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
        cv = pv_all[li][idx].view(b, w * bs, cfg.n_kv_heads, hd)
        attn = _paged_attend(cfg, q, ck, cv, span_mask)
        x = x + attn.to(cfg.compute_dtype) @ lp["wo"][li]
        x = _mlp(cfg, x, params, li)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ _head(cfg, params)).float(), pool


# ---------------------------------------------------------------------------
# Static KV cache programs (port of ``init_kv_cache``, ``prefill``,
# ``write_cache_slot`` and ``decode_step``): cache [L, B, S_max, kv, hd],
# one stripe of S_max positions per sequence slot
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, max_batch: int, max_seq: int,
                  dtype=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Static-shape KV cache for ``max_batch`` sequence slots, zeroed."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, max_batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            rope_cache: Optional[tuple] = None):
    """Full-sequence forward that also returns every layer's K/V.

    tokens [B, S] -> (logits [B, S, V] fp32, kv {"k", "v"} [L, B, S, kv,
    hd] in the compute dtype, K after rope).  ``params`` in their serving
    storage (``param_dtypes``), as the paged programs take them.  Attention is
    ``multi_head_attention`` behind its gate: on a CUDA device at S and
    head_dim multiples of 128 the flash forward kernel."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, None)
    b, s = tokens.shape
    hd = cfg.head_dim
    cos, sin = cos[:s], sin[:s]
    lp = params["layers"]
    x = params["embed"][tokens.long()]
    ks, vs = [], []
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = (h @ lp["wq"][li]).view(b, s, cfg.n_heads, hd)
        k = (h @ lp["wk"][li]).view(b, s, cfg.n_kv_heads, hd)
        v = (h @ lp["wv"][li]).view(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = multi_head_attention(q, k, v, causal=True)
        x = x + attn.reshape(b, s, cfg.n_heads * hd) @ lp["wo"][li]
        x = _mlp(cfg, x, params, li)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = (x @ _head(cfg, params)).float()
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def write_cache_slot(cache: Dict[str, torch.Tensor],
                     kv: Dict[str, torch.Tensor], slot: int
                     ) -> Dict[str, torch.Tensor]:
    """Write one prefilled sequence (``kv`` of batch 1, S <= S_max
    positions; a strided view will do) into positions [0, S) of cache slot
    ``slot``, in place."""
    slot = operator.index(slot)
    for name in ("k", "v"):
        s = kv[name].shape[2]
        cache[name][:, slot:slot + 1, :s].copy_(kv[name])
    return cache


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with fp32 accumulation and an fp32 result from
    cache-dtype operands (JAX's ``preferred_element_type=float32``): no
    fp32 copy of a bf16 operand on the card.  The CPU has no such product
    for bf16, and there the operands are widened (exactly) instead."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, torch.float32)
    return torch.bmm(a.float(), b.float())


def _attend_cache(q, ck, cv, pos_mask):
    """GQA attention of q [B, nh, hd] against one layer's cache rows ck/cv
    [B, S, kv, hd], masked to pos_mask [B, S]; [B, nh*hd] fp32.

    Both products read the cache as it lies, [B, S, kv*hd], with no copy:
    q enters block-diagonally, head (h, j)'s row holding its query in kv
    head h's columns and zeros elsewhere, so one product per batch row
    gives every head's scores (kv times the multiply-adds of the grouped
    product, a few hundred MFLOP per layer at Llama-3-8B's 2,048 positions
    and batch 8, where the cache's bytes set the time), and the PV product
    keeps each head's own kv head's block of its output."""
    b, nh, hd = q.shape
    s, kv = ck.shape[1], ck.shape[2]
    g = nh // kv
    eye = torch.eye(kv, dtype=q.dtype, device=q.device)
    qbd = (q.view(b, kv, g, 1, hd) * eye.view(1, kv, 1, kv, 1)).reshape(
        b, nh, kv * hd)
    scores = _matmul_f32(qbd, ck.view(b, s, kv * hd).transpose(1, 2))
    scores = scores / math.sqrt(hd)
    scores = torch.where(pos_mask[:, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = _matmul_f32(probs.to(cv.dtype), cv.view(b, s, kv * hd))
    out = out.view(b, kv, g, kv, hd).diagonal(dim1=1, dim2=3)  # [B, g, hd, kv]
    return out.permute(0, 3, 1, 2).reshape(b, nh * hd)


def decode_step(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                rope_cache: Optional[tuple] = None):
    """One-token decode for every cache slot.

    tokens [B] int (the token at position lengths[b]); lengths [B] int32.
    Each layer writes the new K/V at position lengths[b] of slot b, in
    place, then attends over positions <= lengths[b].  Slots with no
    sequence compute garbage and write only their own stripe; callers mask
    them.  ``params`` in their serving storage, as for ``prefill``.
    Returns (logits [B, V] fp32, cache) -- the same cache dict.

    Rounding points, as the JAX program's: scores from the cache-dtype
    operands accumulated in fp32 and kept fp32 (on the card by a product
    with an fp32 result, never an fp32 copy of the cache), scaled by
    1/sqrt(hd) and softmaxed in fp32; the probabilities rounded to the
    cache dtype for the PV product, accumulated in fp32; the attention
    output rounded to the compute dtype before ``wo``.  In fp32 every step
    is the JAX program's arithmetic."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, None)
    b = tokens.shape[0]
    s_max = cache["k"].shape[2]
    cdt = cfg.compute_dtype
    hd = cfg.head_dim
    lp = params["layers"]
    bidx = torch.arange(b, device=tokens.device)
    lens = lengths.long()
    pos = lens[:, None]
    pos_mask = torch.arange(s_max, device=tokens.device)[None, :] <= pos
    x = params["embed"][tokens.long()]  # [B, d]
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["attn_norm"][li], cfg.rms_norm_eps)
        q = (h @ lp["wq"][li]).view(b, 1, cfg.n_heads, hd)
        k = (h @ lp["wk"][li]).view(b, 1, cfg.n_kv_heads, hd)
        v = (h @ lp["wv"][li]).view(b, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin, positions=pos)[:, 0]
        k = apply_rope(k, cos, sin, positions=pos)[:, 0]
        ck, cv = cache["k"][li], cache["v"][li]
        ck.index_put_((bidx, lens), k.to(ck.dtype))
        cv.index_put_((bidx, lens), v.to(cv.dtype))
        attn = _attend_cache(q.to(ck.dtype), ck, cv, pos_mask)
        x = x + attn.to(cdt) @ lp["wo"][li]
        x = _mlp(cfg, x, params, li)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ _head(cfg, params)).float(), cache


def check_prefill_chunk(p0: int, c: int, bs: int, w: int) -> None:
    """The host's checks of one prefill chunk before dispatch: p0 and the
    chunk width C block-aligned, and the table's W blocks covering the
    chunk's blocks (JAX's dynamic_slice would clamp a start past the
    table; the engine's fixed width, llm/paged.py _prefill_table_width,
    makes that impossible)."""
    if p0 % bs or c % bs:
        raise ValueError(f"prefill chunk p0={p0}, C={c} not block-aligned ({bs})")
    if p0 // bs + c // bs > w:
        raise ValueError(
            f"prefill table width {w} does not cover blocks "
            f"[{p0 // bs}, {p0 // bs + c // bs})")


def prefill_chunk_paged(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                        pool: Dict[str, torch.Tensor], table: torch.Tensor,
                        p0, rope_cache: Optional[tuple] = None,
                        tp_plan=None):
    """Prefill ONE chunk of a single sequence into its pool blocks.

    tokens [1, C] (C a multiple of block_size; tail garbage-padded -- padded
    positions write blocks the sequence owns and are masked by length
    thereafter); p0 = global position of tokens[0, 0], a multiple of
    block_size: a host int, checked here, or an int tensor of one element
    on tokens' device, which the caller checks (``check_prefill_chunk``)
    and which a CUDA graph reads at each replay, as the JAX program traces
    it; table [1, W] covers positions [0, p0 + C).  Attention is causal
    over the whole prefix: earlier chunks' KV is read back from the pool.
    ``tp_plan`` must be None.  Returns (logits [1, C, V] fp32, pool) -- the
    pool is updated in place."""
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, tp_plan)
    b, c = tokens.shape
    bs = pool["k"].shape[2]
    w = table.shape[1]
    hd = cfg.head_dim
    lp = params["layers"]
    dev = tokens.device
    if isinstance(p0, torch.Tensor):
        p0 = p0.reshape(()).long()
    else:
        check_prefill_chunk(p0, c, bs, w)
    # the C/bs physical blocks this chunk writes: a gather at p0/bs + j, so
    # no host value of p0 is frozen into a captured graph
    chunk_blocks = table[0].long().index_select(
        0, p0 // bs + torch.arange(c // bs, device=dev))
    positions = p0 + torch.arange(c, device=dev)  # [C] global
    span_mask = (torch.arange(w * bs, device=dev)[None, None, :]
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


# ---------------------------------------------------------------------------
# Training: forward and loss (port of ``_layer``, ``forward``, ``loss_fn``)
# ---------------------------------------------------------------------------


def _check_training(cfg: LlamaConfig, mesh, context_parallel: bool) -> None:
    """Refuse what the training forward does not run yet."""
    if mesh is not None or context_parallel:
        raise NotImplementedError(
            "mesh / context_parallel (sharded and ring-attention training) "
            "are not ported to ray_tpu_torch yet (ROADMAP A11)")
    if cfg.remat and cfg.remat_policy not in _REMAT_CONTEXTS:
        raise ValueError(f"remat_policy={cfg.remat_policy!r} — must be one "
                         f"of {sorted(_REMAT_CONTEXTS)}")


def _attention_residual(cfg, x, lp, cos, sin):
    """x + causal self-attention of rms_norm(x), the first half of a block
    (shared with ``models.moe``); products in the compute dtype."""
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = (h @ lp["wq"].to(cdt)).view(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"].to(cdt)).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"].to(cdt)).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = multi_head_attention(q, k, v, causal=True)
    attn = attn.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return x + attn @ lp["wo"].to(cdt)


def _layer(cfg: LlamaConfig, x, lp, cos, sin):
    """One transformer block. x: [B, S, D] in the compute dtype; ``lp``
    this layer's params, cast to the compute dtype at each product."""
    cdt = cfg.compute_dtype
    x = _attention_residual(cfg, x, lp, cos, sin)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    gate = h @ lp["w_gate"].to(cdt)
    up = h @ lp["w_up"].to(cdt)
    return x + (F.silu(gate) * up) @ lp["w_down"].to(cdt)


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, *,
            mesh=None, context_parallel: bool = False,
            rope_cache: Optional[tuple] = None) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, V] (fp32).

    ``cfg.remat`` recomputes each layer in the backward pass, keeping
    what ``cfg.remat_policy`` says (``run_layers``).
    Attention is ``multi_head_attention`` behind its gate (the flash
    kernels on a CUDA device at S and D multiples of 128).
    ``mesh`` and ``context_parallel`` are not ported (A11)."""
    _check_training(cfg, mesh, context_parallel)
    cos, sin = _single_device(cfg, rope_cache, tokens.device, None, None)
    s = tokens.shape[1]
    cos, sin = cos[:s], sin[:s]
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    (x,) = run_layers(cfg, params["layers"], (x,),
                      lambda x, lp: (_layer(cfg, x, lp, cos, sin),))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ _head(cfg, params).to(cfg.compute_dtype)).float()


def _weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep every 2-D product's output (a weight GEMM:
    ``x @ w`` reaches ``aten.mm``), recompute the rest.  Attention's
    batched products (``bmm``) and the flash and grouped-matmul kernels,
    which the dispatcher does not see, are recomputed, as
    ``dots_with_no_batch_dims_saveable`` recomputes JAX's batched dots and
    Pallas calls."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# torch.utils.checkpoint's context_fn per remat policy
_REMAT_CONTEXTS = {
    "full": noop_context_fn,
    "attn": _flash.keep_outputs_contexts,
    "dots": lambda: create_selective_checkpoint_contexts(_weight_products),
}


def run_layers(cfg, layers: Params, carry: tuple, block) -> tuple:
    """``carry = block(*carry, lp)`` over the stacked layers (the JAX
    package's ``lax.scan``), ``lp`` one layer's params by name; with
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, keeping
    what ``cfg.remat_policy`` says (``_REMAT_CONTEXTS``).  Every policy's
    recompute repeats the forward bit for bit, so the gradients are the
    same under each.  The stacked [L, ...] leaves are passed as per-layer
    views, so their gradients come back as one stack per leaf, not as L
    full-size scatters."""
    names = sorted(layers)
    n = len(carry)

    def layer(*args):
        return block(*args[:n], dict(zip(names, args[n:])))

    for leaves in zip(*(layers[k].unbind(0) for k in names)):
        if cfg.remat:
            carry = checkpoint(layer, *carry, *leaves, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=_REMAT_CONTEXTS[cfg.remat_policy])
        else:
            carry = layer(*carry, *leaves)
    return carry


def loss_fn(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, *,
            loss_mask: Optional[torch.Tensor] = None, mesh=None,
            context_parallel: bool = False,
            rope_cache: Optional[tuple] = None) -> torch.Tensor:
    """Next-token cross-entropy (mean over unmasked positions)."""
    logits = forward(cfg, params, tokens, mesh=mesh,
                     context_parallel=context_parallel, rope_cache=rope_cache)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt_logit
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(nll.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs/token for MFU math: the JAX package's
    PaLM-style count, 6N (the embedding table included, though it is a
    gather) plus attention at full, non-causal length."""
    n = cfg.num_params
    attn = 12 * cfg.n_layers * cfg.dim * seq_len  # 2*2*3 * L * d * s (fwd+bwd, QK^T and PV)
    return 6.0 * n + attn

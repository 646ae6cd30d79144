"""Mixtral-style sparse mixture-of-experts decoder LM in PyTorch: the
training forward and loss.

Port of ``ray_tpu/models/moe.py`` on one device.  The layout stays the JAX
package's, so ``ray_tpu_torch.convert`` carries its params over as copies:
the layers stacked on a leading axis, every projection oriented for
``x @ w``, the experts [L, E, d, f] (``w_down`` [L, E, f, d]), the router
[L, d, E] kept in fp32 (routing decisions are precision-sensitive).
Attention, norms and rope are the port's Llama ones.

Dispatch, as the JAX package's ``MoEConfig.dispatch``:
  - ``moe_block_ragged`` ("auto" without a mesh, or "ragged"): the
    token-expert pairs sorted by expert with a counting sort, the three
    expert products as grouped matmuls over the contiguous groups
    (``ops.grouped_matmul``: the CUDA kernels on a CUDA device, where the
    JAX package takes megablox on a TPU; the plain version elsewhere, the
    counterpart of ``lax.ragged_dot``), results added back per token;
  - ``moe_block_sorted_capacity``: the same sort, experts padded to a
    capacity and run as batched products; pairs past it drop;
  - ``moe_block`` "dense": GShard's capacity-bounded one-hot dispatch.

Nothing in a block waits for the host: the sort is cumulative sums of
one-hots, the group sizes stay on the device, and the kernels read them
there.  The scatter-add back to tokens (JAX's ``y.at[tok].add``) is
``index_add`` in the compute dtype, whose CUDA atomics add in no fixed
order; starting from zero, 0 + a + b rounds once whichever comes first,
so with ``experts_per_token <= 2`` the result does not depend on the
order.  With k > 2 it would.

The remat policies are the Llama ones (``llama.run_layers``): "attn"
keeps the flash forward's O and LSE; "dots" keeps every 2-D product's
output (the router's among them), not the grouped matmuls', as JAX's
``dots_with_no_batch_dims_saveable`` keeps no megablox or ``ragged_dot``
output.

Not ported yet (ROADMAP A11 item 6): meshes (``param_specs``, sharding
constraints, expert parallelism).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.grouped_matmul import gmm_reference, grouped_matmul
from ray_tpu_torch.ops.norms import rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # "auto": the ragged grouped matmul without a mesh (the drop-free path);
    # "ragged" / "dense" / "sorted_capacity" force one implementation
    dispatch: str = "auto"
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"  # "full" | "attn" | "dots" (see llama.py)

    def __post_init__(self):
        valid = ("auto", "ragged", "dense", "sorted_capacity")
        if self.dispatch not in valid:
            raise ValueError(
                f"dispatch={self.dispatch!r} — must be one of {valid}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def num_params(self) -> int:
        d, f, v, e = self.dim, self.ffn_dim, self.vocab_size, self.n_experts
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        per_layer = d * hq + 2 * d * hkv + hq * d + d * e + 3 * e * d * f + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    @property
    def num_active_params(self) -> int:
        """Params touched per token (the router picks k of E experts)."""
        d, f, v, k = self.dim, self.ffn_dim, self.vocab_size, self.experts_per_token
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        per_layer = d * hq + 2 * d * hkv + hq * d + d * self.n_experts + 3 * k * d * f + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    # ---- presets ----
    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MoEConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "MoEConfig":
        """Test-sized config: runs in milliseconds on a CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("ffn_dim", 128)
        kw.setdefault("n_experts", 4)
        kw.setdefault("experts_per_token", 2)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("compute_dtype", torch.float32)
        return cls(**kw)


def train_param_dtypes(cfg: MoEConfig) -> Dict[str, torch.dtype]:
    """Storage dtype of each parameter, as the JAX package stores them:
    ``cfg.param_dtype``, and fp32 for the router.  ``forward`` casts each
    projection to the compute dtype at its use."""
    names = ("embed", "lm_head", "final_norm", "attn_norm", "mlp_norm", "wq",
             "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    out = {k: cfg.param_dtype for k in names}
    out["router"] = torch.float32
    return out


def init_params(cfg: MoEConfig, generator: torch.Generator, device,
                dtypes: Optional[Dict[str, torch.dtype]] = None) -> Params:
    """Random stacked-layers params (the JAX package's scheme: normal with
    std 0.02, output projections scaled by 1/sqrt(2L), unit norms), drawn
    from ``generator`` on ``device``, stored as ``dtypes`` says (default
    ``train_param_dtypes``).  The numbers differ from ``ray_tpu``'s for the
    same seed; parity tests carry JAX's weights over with ``convert``."""
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    dts = train_param_dtypes(cfg) if dtypes is None else dtypes

    def normal(name, shape, s):
        return torch.empty(shape, dtype=dts[name], device=device).normal_(
            0.0, s, generator=generator)

    def ones(name, shape):
        return torch.ones(shape, dtype=dts[name], device=device)

    return {
        "embed": normal("embed", (cfg.vocab_size, d), std),
        "layers": {
            "attn_norm": ones("attn_norm", (L, d)),
            "wq": normal("wq", (L, d, hq), std),
            "wk": normal("wk", (L, d, hkv), std),
            "wv": normal("wv", (L, d, hkv), std),
            "wo": normal("wo", (L, hq, d), out_std),
            "mlp_norm": ones("mlp_norm", (L, d)),
            "router": normal("router", (L, d, e), std),
            "w_gate": normal("w_gate", (L, e, d, f), std),
            "w_up": normal("w_up", (L, e, d, f), std),
            "w_down": normal("w_down", (L, e, f, d), out_std),
        },
        "final_norm": ones("final_norm", (d,)),
        "lm_head": normal("lm_head", (d, cfg.vocab_size), std),
    }


def param_specs(cfg: MoEConfig):
    """The JAX package's sharding specs: meshes are not ported."""
    raise NotImplementedError(
        "param_specs (expert-parallel and fsdp sharding) is not ported to "
        "ray_tpu_torch yet (ROADMAP A11 item 6)")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh (sharded and expert-parallel MoE) is not ported to "
            "ray_tpu_torch yet (ROADMAP A11 item 6)")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot [..., n] by comparison (``F.one_hot`` checks its range
    on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def _router(cfg: MoEConfig, xt, lp):
    """Shared routing head: top-k expert ids, renormalised weights and the
    Switch load-balance aux loss.  xt: [T, d]."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ lp["router"].float()             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)          # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch): E * sum_e frac_routed_e * mean_prob_e
    frac_routed = _one_hot(top_idx[:, 0], e).float().mean(0)
    mean_prob = probs.mean(0)
    aux = e * torch.sum(frac_routed * mean_prob)
    return top_w, top_idx, aux


def _counting_sort(flat_e: torch.Tensor, n_experts: int):
    """(rank [N] int32 of each pair within its expert, group_sizes [E]
    int32) by cumulative sums of one-hots: O(N E) vector work, no host
    sync.  The one-hots lie [E, N], so the scan runs along the contiguous
    axis (a scan down the N rows of [N, E] took 2.6 ms per call at N =
    16384 on an H100 80GB HBM3 at 700 W, in chip_smoke.py's profile)."""
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[None, :] == experts[:, None]).to(torch.int32)  # [E, N]
    csum = torch.cumsum(onehot, 1, dtype=torch.int32)
    rank = csum.gather(0, flat_e[None, :].long())[0] - 1
    return rank, onehot.sum(1, dtype=torch.int32)


def _sorted_order(flat_e: torch.Tensor, n_experts: int):
    """(order [N] int32, group_sizes [E] int32): order maps each sorted slot
    to its source pair, pairs grouped by expert and stable within one (as
    a stable argsort would order them)."""
    rank, group_sizes = _counting_sort(flat_e, n_experts)
    offsets = torch.cumsum(group_sizes, 0, dtype=torch.int32) - group_sizes
    pos = rank + offsets[flat_e]                   # sorted slot of each pair
    ar = torch.arange(flat_e.shape[0], dtype=torch.int32, device=flat_e.device)
    return torch.zeros_like(ar).scatter_(0, pos.long(), ar), group_sizes


def _gmm_supported(device, mesh) -> bool:
    """Whether the grouped-matmul kernels apply: a CUDA device and no mesh
    (the JAX package's gate with a CUDA device in place of the TPU; where
    the kernels cannot take a call on CUDA, their wrappers raise)."""
    return mesh is None and torch.device(device).type == "cuda"


def _grouped_matmul(cfg: MoEConfig, use_gmm: bool, a, b, group_sizes):
    """One grouped matmul over expert-contiguous rows: the kernels' autograd
    Function where supported, else the plain version (``lax.ragged_dot``'s
    counterpart, differentiated by autograd)."""
    if use_gmm:
        return grouped_matmul(a, b, group_sizes)
    return gmm_reference(a, b, group_sizes)


def moe_block_ragged(cfg: MoEConfig, x, lp, mesh=None):
    """Sorted/ragged top-k MoE FFN: the token-expert pairs sorted by expert,
    each expert projection ONE grouped matmul over the contiguous groups,
    results added back per token.  Exactly 3 * 2 * T * k * d * f product
    flops, no capacity padding, no token dropped.
    x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    _no_mesh(mesh)
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    k = cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    top_w, top_idx, aux = _router(cfg, xt, lp)

    flat_e = top_idx.reshape(-1)                   # [N] expert of each pair
    order, group_sizes = _sorted_order(flat_e, cfg.n_experts)
    tok = (order // k).long()                      # source token per slot
    sx = xt[tok].to(cdt)                           # [N, d]

    use_gmm = _gmm_supported(x.device, mesh)
    gate = _grouped_matmul(cfg, use_gmm, sx, lp["w_gate"].to(cdt), group_sizes)
    up = _grouped_matmul(cfg, use_gmm, sx, lp["w_up"].to(cdt), group_sizes)
    act = F.silu(gate) * up
    out = _grouped_matmul(cfg, use_gmm, act, lp["w_down"].to(cdt),
                          group_sizes)             # [N, d]

    w_sorted = top_w.reshape(-1)[order.long()].to(out.dtype)
    y = torch.zeros((t, d), dtype=out.dtype, device=x.device).index_add(
        0, tok, out * w_sorted[:, None])
    return y.reshape(b, s, d), aux


def moe_block_sorted_capacity(cfg: MoEConfig, x, lp):
    """Counting-sort dispatch + padded batched-matmul expert FFN: pairs
    ranked past ``capacity_factor * T*k/E`` (rounded up to 128, at most T)
    within their expert are dropped (contribute zero).
    x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    n = t * k
    cap = int(math.ceil(cfg.capacity_factor * n / e))
    cap = min(t, ((cap + 127) // 128) * 128)
    xt = x.reshape(t, d)
    top_w, top_idx, aux = _router(cfg, xt, lp)

    flat_e = top_idx.reshape(-1)                           # [N]
    rank, _ = _counting_sort(flat_e, e)
    keep = rank < cap
    trash = e * cap                                        # overflow row
    dst = torch.where(keep, flat_e * cap + rank, trash).long()  # [N]
    pair_tok = torch.arange(n, device=x.device) // k
    sx = xt[pair_tok].to(cdt)                              # [N, d]
    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=x.device).index_put(
        (dst,), sx)
    xg = buf[:e * cap].reshape(e, cap, d)

    gate = torch.matmul(xg, lp["w_gate"].to(cdt))
    up = torch.matmul(xg, lp["w_up"].to(cdt))
    out = torch.matmul(F.silu(gate) * up, lp["w_down"].to(cdt))

    # overflow pairs (dst == e*cap) read zeros
    flat = out.reshape(e * cap, d)
    pair_out = torch.where(keep[:, None], flat[dst.clamp(max=e * cap - 1)],
                           torch.zeros((), dtype=flat.dtype, device=x.device))
    w_pair = (top_w.reshape(-1) * keep).to(pair_out.dtype)
    y = torch.zeros((t, d), dtype=pair_out.dtype, device=x.device).index_add(
        0, pair_tok, pair_out * w_pair[:, None])
    return y.reshape(b, s, d), aux


def moe_block(cfg: MoEConfig, x, lp, mesh=None):
    """The MoE FFN by ``cfg.dispatch``; "dense" (and "auto" under a mesh,
    which is not ported) is the capacity-bounded GShard dispatch.
    x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    _no_mesh(mesh)
    if cfg.dispatch == "sorted_capacity":
        return moe_block_sorted_capacity(cfg, x, lp)
    if cfg.dispatch in ("ragged", "auto"):
        return moe_block_ragged(cfg, x, lp)
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    cap = min(int(math.ceil(cfg.capacity_factor * k * t / e)), t)
    xt = x.reshape(t, d)
    top_w, top_idx, aux = _router(cfg, xt, lp)

    # dispatch/combine tensors [T, E, cap]; k=0 choices fill slots first
    dispatch = torch.zeros((t, e, cap), dtype=torch.bool, device=x.device)
    combine = torch.zeros((t, e, cap), dtype=torch.float32, device=x.device)
    position_base = torch.zeros((e,), dtype=torch.int32, device=x.device)
    for ki in range(k):
        onehot = _one_hot(top_idx[:, ki], e)                            # [T, E]
        pos = torch.cumsum(onehot, 0, dtype=torch.int32) - 1 + position_base[None, :]
        position_base = position_base + onehot.sum(0, dtype=torch.int32)
        keep = (pos < cap) & (onehot > 0)
        pos_oh = _one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap] > 0
        dispatch = dispatch | pos_oh
        combine = combine + pos_oh.float() * top_w[:, ki, None, None]

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(cdt), xt.to(cdt))
    gate = torch.matmul(expert_in, lp["w_gate"].to(cdt))
    up = torch.matmul(expert_in, lp["w_up"].to(cdt))
    out = torch.matmul(F.silu(gate) * up, lp["w_down"].to(cdt))
    y = torch.einsum("tec,ecd->td", combine.to(cdt), out.to(cdt))
    return y.reshape(b, s, d), aux


def _layer(cfg: MoEConfig, x, aux_acc, lp, cos, sin):
    """One MoE block: attention, then the expert FFN; carries the summed
    aux loss."""
    x = llama._attention_residual(cfg, x, lp, cos, sin)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    ffn, aux = moe_block(cfg, h, lp)
    return x + ffn, aux_acc + aux


def forward(cfg: MoEConfig, params: Params, tokens: torch.Tensor, *,
            mesh=None, context_parallel: bool = False,
            rope_cache: Optional[tuple] = None):
    """Token ids [B, S] -> (logits [B, S, V] fp32, aux_loss scalar).

    ``context_parallel`` is accepted and ignored, as the JAX function does;
    ``mesh`` is not ported (A11)."""
    del context_parallel
    _no_mesh(mesh)
    llama._check_training(cfg)  # remat policy
    if rope_cache is None:
        rope_cache = llama.rope_cache(cfg, cfg.max_seq_len, tokens.device)
    s = tokens.shape[1]
    cos, sin = rope_cache[0][:s], rope_cache[1][:s]
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    aux0 = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x, aux = llama.run_layers(
        cfg, params["layers"], (x, aux0),
        lambda x, aux, lp: _layer(cfg, x, aux, lp, cos, sin))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = (x @ params["lm_head"].to(cfg.compute_dtype)).float()
    return logits, aux / cfg.n_layers


def loss_fn(cfg: MoEConfig, params: Params, tokens: torch.Tensor, *,
            loss_mask: Optional[torch.Tensor] = None, mesh=None,
            context_parallel: bool = False,
            rope_cache: Optional[tuple] = None) -> torch.Tensor:
    """Next-token cross-entropy + ``aux_loss_coef`` x the load-balancing
    aux term."""
    logits, aux = forward(cfg, params, tokens, mesh=mesh,
                          context_parallel=context_parallel,
                          rope_cache=rope_cache)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt_logit
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(nll.dtype)
        ce = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        ce = nll.mean()
    return ce + cfg.aux_loss_coef * aux


def flops_per_token(cfg: MoEConfig, seq_len: int) -> float:
    """Training FLOPs/token by *active* params (what MFU measures): 6N_active
    plus attention at full length."""
    n = cfg.num_active_params
    attn = 12 * cfg.n_layers * cfg.dim * seq_len
    return 6.0 * n + attn

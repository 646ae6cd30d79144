"""Mixtral-style sparse mixture-of-experts decoder LM in PyTorch: the
training forward and loss, on one device or over a mesh.

Port of ``ray_tpu/models/moe.py``.  The layout stays the JAX package's, so
``ray_tpu_torch.convert`` carries its params over as copies: the layers
stacked on a leading axis, every projection oriented for ``x @ w``, the
experts [L, E, d, f] (``w_down`` [L, E, f, d]), the router [L, d, E] kept
in fp32 (routing decisions are precision-sensitive).  Attention, norms
and rope are the port's Llama ones.

Dispatch (``moe_block``), as the JAX package's ``MoEConfig.dispatch``:
  - "ragged" ("auto" without a mesh): the token-expert pairs sorted by
    expert with a counting sort, the three expert products as grouped
    matmuls over the contiguous groups (``ops.grouped_matmul``: the CUDA
    kernels on a CUDA device, where the JAX package takes megablox on a
    TPU; the plain version elsewhere, the counterpart of
    ``lax.ragged_dot``), results added back per token;
  - "sorted_capacity": the same sort, experts padded to a capacity and
    run as batched products; pairs past it drop;
  - "dense" ("auto" under a mesh): GShard's capacity-bounded dispatch,
    its one-hot dispatch einsum as the scatter into capacity slots it
    equals (each slot holds one token), its combine as the weighted sum
    of each token's at most k slots.

Under a mesh (one process per rank, ``parallel.mesh``) the block computes
the JAX function's global result: activations split their batch over
:data:`MOE_BATCH_AXES`, capacity slots count over the global token
order, the aux loss's means over the global batch, and the expert axis
exchanges tokens by all-to-all (``moe_block``).  ``param_specs`` are
JAX's.

Nothing in a block waits for the host: the sort is cumulative sums of
one-hots, the group sizes stay on the device, and the kernels read them
there.  The scatter-add back to tokens (JAX's ``y.at[tok].add``) is
``index_add`` in the compute dtype, whose CUDA atomics add in no fixed
order; starting from zero, 0 + a + b rounds once whichever comes first,
so with ``experts_per_token <= 2`` the result does not depend on the
order (nor on which rank adds which term: zeros add exactly).  With
k > 2 it would.

The remat policies are the Llama ones (``llama.run_layers``): "attn"
keeps the flash forward's O and LSE; "dots" keeps every 2-D product's
output (the router's among them), not the grouped matmuls', as JAX's
``dots_with_no_batch_dims_saveable`` keeps no megablox or ``ragged_dot``
output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.grouped_matmul import gmm_reference, grouped_matmul
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel import functional as _fn
from ray_tpu_torch.parallel.mesh import MOE_BATCH_AXES

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
                dtypes: Optional[Dict[str, torch.dtype]] = None,
                place: Optional[Callable[[tuple, torch.Tensor], Any]] = None
                ) -> Params:
    """Random stacked-layers params (the JAX package's scheme: normal with
    std 0.02, output projections scaled by 1/sqrt(2L), unit norms), drawn
    from ``generator`` on ``device``, stored as ``dtypes`` says (default
    ``train_param_dtypes``).  The numbers differ from ``ray_tpu``'s for the
    same seed; parity tests carry JAX's weights over with ``convert``.
    ``place(path, tensor)`` as ``llama.init_params`` takes it: each tensor
    drawn whole, then turned into the leaf kept (a rank's shard)."""
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    dts = train_param_dtypes(cfg) if dtypes is None else dtypes
    keep = place or (lambda path, t: t)

    def normal(path, shape, s):
        return keep(path, torch.empty(
            shape, dtype=dts[path[-1]], device=device).normal_(
                0.0, s, generator=generator))

    def ones(path, shape):
        return keep(path, torch.ones(shape, dtype=dts[path[-1]],
                                     device=device))

    lay = "layers"
    return {
        "embed": normal(("embed",), (cfg.vocab_size, d), std),
        "layers": {
            "attn_norm": ones((lay, "attn_norm"), (L, d)),
            "wq": normal((lay, "wq"), (L, d, hq), std),
            "wk": normal((lay, "wk"), (L, d, hkv), std),
            "wv": normal((lay, "wv"), (L, d, hkv), std),
            "wo": normal((lay, "wo"), (L, hq, d), out_std),
            "mlp_norm": ones((lay, "mlp_norm"), (L, d)),
            "router": normal((lay, "router"), (L, d, e), std),
            "w_gate": normal((lay, "w_gate"), (L, e, d, f), std),
            "w_up": normal((lay, "w_up"), (L, e, d, f), std),
            "w_down": normal((lay, "w_down"), (L, e, f, d), out_std),
        },
        "final_norm": ones(("final_norm",), (d,)),
        "lm_head": normal(("lm_head",), (d, cfg.vocab_size), std),
    }


def param_specs(cfg: MoEConfig) -> Params:
    """The JAX package's partition specs: experts over "expert", Megatron
    over "tensor" (gate/up column-, down row-sharded), fsdp on the other
    large dim, the router replicated."""
    return {
        "embed": ("tensor", "fsdp"),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, "fsdp", "tensor"),
            "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"),
            "wo": (None, "tensor", "fsdp"),
            "mlp_norm": (None, None),
            "router": (None, None, None),
            "w_gate": (None, "expert", "fsdp", "tensor"),
            "w_up": (None, "expert", "fsdp", "tensor"),
            "w_down": (None, "expert", "tensor", "fsdp"),
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tensor"),
    }


# each expert weight's fsdp-sharded dim within one layer's slice
_EXPERT_FSDP_DIM = {"w_gate": 1, "w_up": 1, "w_down": 2}


def shard_context(mesh) -> llama.Shard:
    """The Llama forward's :class:`llama.Shard` with the batch split over
    :data:`MOE_BATCH_AXES` (``llama.UNSHARDED`` without a mesh).  MoE
    takes no context parallelism: a context axis replicates the work."""
    return llama.shard_context(mesh, False, MOE_BATCH_AXES)


def _refuse_pipeline(mesh) -> None:
    if mesh is not None and mesh.shape["pipeline"] > 1:
        raise NotImplementedError(
            "pipeline parallelism is wired for the llama family; MoE "
            "pipelines need an expert-aware stage split")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot [..., n] by comparison (``F.one_hot`` checks its range
    on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def _router(cfg: MoEConfig, xt, lp, sh: llama.Shard = llama.UNSHARDED):
    """Shared routing head: top-k expert ids, renormalised weights and the
    Switch load-balance aux loss.  xt: [T, d], this rank's tokens; the
    aux loss's two means run over the global batch (their sums reduced
    over the batch axes first, then multiplied)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ lp["router"].float()             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)          # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch): E * sum_e frac_routed_e * mean_prob_e
    sums = _fn.psum(torch.stack([_one_hot(top_idx[:, 0], e).float().sum(0),
                                 probs.sum(0)]), sh.batch)
    frac_routed, mean_prob = sums / (xt.shape[0] * sh.nb)
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


def _gmm_supported(device) -> bool:
    """Whether the grouped-matmul kernels apply: a CUDA device (where the
    kernels cannot take a call on CUDA, their wrappers raise).  The JAX
    package also refuses them under a mesh, a Pallas call having no GSPMD
    partitioning rule; one process per rank launches them on its own
    experts' groups."""
    return torch.device(device).type == "cuda"


def _grouped_matmul(cfg: MoEConfig, use_gmm: bool, a, b, group_sizes):
    """One grouped matmul over expert-contiguous rows: the kernels' autograd
    Function where supported, else the plain version (``lax.ragged_dot``'s
    counterpart, differentiated by autograd)."""
    if use_gmm:
        return grouped_matmul(a, b, group_sizes)
    return gmm_reference(a, b, group_sizes)


def _global_counts(counts: torch.Tensor, sh: llama.Shard):
    """(the batch ranks before this one's summed counts, every rank's
    summed counts) of per-rank ``counts``: the global token order is
    rank-major over the batch axes, so a pair's place among the global
    pairs of its expert is its place among this rank's plus the prefix."""
    if sh.batch is None:
        return torch.zeros_like(counts), counts
    every = sh.batch.all_gather(counts[None].contiguous(), dim=0)
    return (every[:sh.b_rank].sum(0, dtype=counts.dtype),
            every.sum(0, dtype=counts.dtype))


def _dense_slots(cfg: MoEConfig, top_idx, sh: llama.Shard):
    """GShard's capacity slots of this rank's (token, choice) pairs, as the
    JAX function assigns them over the global batch: every k = 0 choice
    fills its expert's slots before any k = 1 choice, each in global token
    order.  Returns (slot [T, k] int32, keep [T, k], cap)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t_all = top_idx.shape[0] * sh.nb
    cap = min(int(math.ceil(cfg.capacity_factor * k * t_all / e)), t_all)
    onehots = [_one_hot(top_idx[:, ki], e) for ki in range(k)]      # [T, E]
    prefix, total = _global_counts(
        torch.stack([oh.sum(0, dtype=torch.int32) for oh in onehots]), sh)
    base = torch.cumsum(total, 0, dtype=torch.int32) - total          # [k, E]
    slot = torch.stack([
        (torch.cumsum(oh, 0, dtype=torch.int32) - 1 + prefix[ki] + base[ki])
        .gather(1, top_idx[:, ki:ki + 1])[:, 0]
        for ki, oh in enumerate(onehots)], 1)
    return slot, slot < cap, cap


def _sorted_slots(cfg: MoEConfig, top_idx, sh: llama.Shard):
    """``sorted_capacity``'s slots: each pair's rank within its expert over
    the global pairs in (token, choice) order; pairs past ``capacity_factor
    * N/E`` (rounded up to 128, at most the global T) drop.  Returns (slot
    [T, k] int32, keep [T, k], cap)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t_all = top_idx.shape[0] * sh.nb
    cap = int(math.ceil(cfg.capacity_factor * t_all * k / e))
    cap = min(t_all, ((cap + 127) // 128) * 128)
    flat_e = top_idx.reshape(-1)
    rank, counts = _counting_sort(flat_e, e)
    prefix, _ = _global_counts(counts, sh)
    slot = (rank + prefix[flat_e]).reshape(top_idx.shape)
    return slot, slot < cap, cap


def _expert_weights(cfg: MoEConfig, lp, sh: llama.Shard):
    """This rank's experts' gate, up and down weights in the compute dtype,
    all-gathered over fsdp (inside the layer's checkpoint region)."""
    return [_fn.all_gather(lp[n], sh.fsdp, _EXPERT_FSDP_DIM[n],
                           dtype=cfg.compute_dtype)
            for n in ("w_gate", "w_up", "w_down")]


def _to_owners(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``x`` [T, ...] in member order ([size * T, ...]), as
    an all-to-all of ``x`` repeated once per member: each member sends
    its tokens to every owner of experts.  Over NCCL on four H100 80GB
    HBM3 cards at 700 W (``chip_smoke.py --train-cards 4``, 4096 x 4096
    bf16 a rank, two runs) the all-to-all took 0.42-0.47 ms a way, the
    all-gather and reduce-scatter that move the same bytes 0.51-2.78 and
    0.45-1.69."""
    if group is None:
        return x
    return _fn.all_to_all(x.repeat((group.size,) + (1,) * (x.dim() - 1)),
                          group)


def _from_owners(y: torch.Tensor, group) -> torch.Tensor:
    """Each member's block of ``y`` [size * T, ...] summed over the
    members that computed one (the inverse all-to-all, then a sum over
    the received blocks; its backward is ``_to_owners``')."""
    if group is None:
        return y
    return _fn.all_to_all(y, group).unflatten(0, (group.size, -1)).sum(0)


def moe_block(cfg: MoEConfig, x, lp, mesh=None,
              sh: Optional[llama.Shard] = None):
    """The MoE FFN by ``cfg.dispatch``: "ragged" ("auto" without a mesh)
    the grouped matmuls, "dense" ("auto" under a mesh, as the JAX
    function reads it) GShard's capacity-bounded dispatch,
    "sorted_capacity" its counting-sort twin.  x: [B, S, d], this rank's
    tokens -> ([B, S, d], aux_loss scalar).

    Under a mesh (``sh``, or ``mesh``'s MoE shard) the function is the
    JAX one's over the global batch.  Routing is per token; the capacity
    slots count over the global token order (``_global_counts``).  The
    expert axis exchanges tokens: each rank of an expert group sends its
    tokens to every member (``_to_owners``, an all-to-all), each runs its
    own experts' FFN on the pairs routed to them (gate/up column-sharded
    over "tensor", down row-sharded) and adds them back per token,
    weighted; the inverse all-to-all hands each rank every owner's sum for
    its tokens, added up (``_from_owners``), and "tensor" sums the down
    projection's partial products.  Each token takes at most
    ``experts_per_token`` <= 2 nonzero terms, so zeros and the order of
    the sums leave it exact."""
    if sh is None:
        sh = shard_context(mesh)
    dispatch = cfg.dispatch
    if dispatch == "auto":
        dispatch = "ragged" if sh.mesh is None else "dense"
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cdt = cfg.compute_dtype
    t = b * s
    xt = x.reshape(t, d)
    top_w, top_idx, aux = _router(cfg, xt, lp, sh)

    # the expert group's tokens and routing, in global token order
    ex = sh.mesh.axis_group("expert") if sh.mesh is not None else None
    n_ex = sh.mesh.shape["expert"] if sh.mesh is not None else 1
    e_loc = e // n_ex
    lo = (sh.mesh.coords["expert"] if sh.mesh is not None else 0) * e_loc
    # both read by the tensor axis's partial products: behind pvary
    xg = _to_owners(_fn.pvary(xt, sh.tensor), ex)
    wg = _fn.all_gather(_fn.pvary(top_w, sh.tensor), ex, 0)
    if dispatch == "ragged":
        route = top_idx
    else:
        slot, keep, cap = (_dense_slots if dispatch == "dense"
                           else _sorted_slots)(cfg, top_idx, sh)
        route = torch.stack([top_idx, torch.where(keep, slot, -1).long()], -1)
    if ex is not None:
        route = ex.all_gather(route.contiguous(), dim=0)
    idx_g = route if dispatch == "ragged" else route[..., 0]
    mine = (idx_g >= lo) & (idx_g < lo + e_loc)             # [Tg, k]
    if dispatch != "ragged":
        mine = mine & (route[..., 1] >= 0)
    local_e = (idx_g - lo).reshape(-1)
    n = local_e.shape[0]
    w_gate, w_up, w_down = _expert_weights(cfg, lp, sh)

    if dispatch == "ragged":
        # this rank's pairs sorted by its experts; the others after the
        # last group, where the kernels write zeros
        trash = n_ex > 1
        flat_e = torch.where(mine.reshape(-1), local_e, e_loc) if trash \
            else local_e
        order, group_sizes = _sorted_order(flat_e, e_loc + trash)
        if trash:
            group_sizes = group_sizes[:e_loc]
        tok = (order // k).long()                  # source token per slot
        sx = xg[tok].to(cdt)                       # [N, d]
        use_gmm = _gmm_supported(x.device)
        gate = _grouped_matmul(cfg, use_gmm, sx, w_gate, group_sizes)
        up = _grouped_matmul(cfg, use_gmm, sx, w_up, group_sizes)
        act = F.silu(gate) * up
        out = _grouped_matmul(cfg, use_gmm, act, w_down, group_sizes)
        w_pair = wg.reshape(-1)
        if trash:
            w_pair = w_pair * mine.reshape(-1)
        w_pair = w_pair[order.long()]
        pair_tok = tok
    else:
        # the capacity slots of this rank's experts: [E_loc, cap, d]
        keep_l = mine.reshape(-1)
        dst = torch.where(keep_l, local_e * cap + route[..., 1].reshape(-1),
                          e_loc * cap).long()              # overflow row
        pair_tok = torch.arange(n, device=x.device) // k
        sx = xg[pair_tok].to(cdt)                          # [N, d]
        buf = torch.zeros((e_loc * cap + 1, d), dtype=cdt,
                          device=x.device).index_put((dst,), sx)
        xb = buf[:e_loc * cap].reshape(e_loc, cap, d)
        gate = torch.matmul(xb, w_gate)
        up = torch.matmul(xb, w_up)
        flat = torch.matmul(F.silu(gate) * up, w_down).reshape(e_loc * cap, d)
        # dropped and others' pairs (dst == e_loc*cap) read zeros
        out = torch.where(keep_l[:, None], flat[dst.clamp(max=e_loc * cap - 1)],
                          torch.zeros((), dtype=flat.dtype, device=x.device))
        w_pair = wg.reshape(-1) * keep_l
    yg = torch.zeros((xg.shape[0], d), dtype=out.dtype,
                     device=x.device).index_add(
        0, pair_tok, out * w_pair.to(out.dtype)[:, None])
    y = _fn.psum(_from_owners(yg, ex), sh.tensor)
    return y.reshape(b, s, d), aux


def moe_block_ragged(cfg: MoEConfig, x, lp, mesh=None):
    """Sorted/ragged top-k MoE FFN: the token-expert pairs sorted by expert,
    each expert projection ONE grouped matmul over the contiguous groups,
    results added back per token.  Exactly 3 * 2 * T * k * d * f product
    flops, no capacity padding, no token dropped.
    x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    return moe_block(dataclasses.replace(cfg, dispatch="ragged"), x, lp, mesh)


def moe_block_sorted_capacity(cfg: MoEConfig, x, lp, mesh=None):
    """Counting-sort dispatch + padded batched-matmul expert FFN: pairs
    ranked past ``capacity_factor * T*k/E`` (rounded up to 128, at most T)
    within their expert are dropped (contribute zero).
    x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    return moe_block(dataclasses.replace(cfg, dispatch="sorted_capacity"), x,
                     lp, mesh)


def _layer(cfg: MoEConfig, x, aux_acc, lp, cos, sin, sh: llama.Shard):
    """One MoE block: attention (Llama's, sharded as ``sh`` says), then the
    expert FFN; carries the summed aux loss."""
    x = llama._attention_residual(cfg, x, lp, cos, sin, sh)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    ffn, aux = moe_block(cfg, h, lp, sh=sh)
    return x + ffn, aux_acc + aux


def forward(cfg: MoEConfig, params: Params, tokens: torch.Tensor, *,
            mesh=None, context_parallel: bool = False,
            rope_cache: Optional[tuple] = None):
    """Token ids [B, S] -> (logits [B, S, V] fp32, aux_loss scalar).

    ``context_parallel`` is accepted and ignored, as the JAX function does.
    With ``mesh`` (one rank's view, ``parallel.mesh``; no pipeline axis)
    ``params`` are this rank's shards by ``param_specs`` and ``tokens`` the
    GLOBAL batch; the logits are this rank's block, ``P(MOE_BATCH_AXES,
    None, "tensor")``, and the aux loss the global one.  Attention, the
    embedding and the head run as Llama's sharded forward runs them."""
    del context_parallel
    _refuse_pipeline(mesh)
    llama._check_training(cfg)  # remat policy
    sh = shard_context(mesh)
    if rope_cache is None:
        rope_cache = llama.rope_cache(cfg, cfg.max_seq_len, tokens.device)
    s = tokens.shape[1]
    cos, sin = rope_cache[0][:s], rope_cache[1][:s]
    tokens = sh.local_tokens(tokens)
    x = llama.embed_tokens(cfg, llama.embed_table(params, sh), tokens, sh)
    aux0 = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x, aux = llama.run_layers(
        cfg, params["layers"], (x, aux0),
        lambda x, aux, lp: _layer(cfg, x, aux, lp, cos, sin, sh))
    head = _fn.all_gather(params["lm_head"], sh.fsdp, 0,
                          dtype=cfg.compute_dtype)
    logits = llama.head_logits(cfg, params, x, head, sh)
    return logits, aux / cfg.n_layers


def loss_fn(cfg: MoEConfig, params: Params, tokens: torch.Tensor, *,
            loss_mask: Optional[torch.Tensor] = None, mesh=None,
            context_parallel: bool = False,
            rope_cache: Optional[tuple] = None) -> torch.Tensor:
    """Next-token cross-entropy + ``aux_loss_coef`` x the load-balancing
    aux term.  With ``mesh``: ``tokens`` (and ``loss_mask``) the global
    batch, the cross-entropy the global mean over the MoE batch axes, the
    same on every rank."""
    logits, aux = forward(cfg, params, tokens, mesh=mesh,
                          context_parallel=context_parallel,
                          rope_cache=rope_cache)
    sh = shard_context(mesh)
    bl = tokens.shape[0] // sh.nb
    rows = slice(sh.b_rank * bl, (sh.b_rank + 1) * bl)
    nll = llama.token_nll(logits[:, :-1], tokens[rows, 1:], sh)
    if loss_mask is not None:
        m = loss_mask[rows, 1:].to(nll.dtype)
        ce = (_fn.psum((nll * m).sum(), sh.batch)
              / torch.clamp(_fn.psum(m.sum(), sh.batch), min=1.0))
    else:
        ce = _fn.psum(nll.mean(), sh.batch) / sh.nb  # equal shards
    return ce + cfg.aux_loss_coef * aux


def flops_per_token(cfg: MoEConfig, seq_len: int) -> float:
    """Training FLOPs/token by *active* params (what MFU measures): 6N_active
    plus attention at full length."""
    n = cfg.num_active_params
    attn = 12 * cfg.n_layers * cfg.dim * seq_len
    return 6.0 * n + attn

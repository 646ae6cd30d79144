"""Training-step builder for the Llama and MoE families, on one device.

Port of ``ray_tpu/parallel/train_step.py:make_train_step`` without a mesh:
``init_fn(generator) -> TrainState`` and ``step_fn(state, tokens) ->
(state, metrics)``.  The optimizer is the JAX builder's default, optax's
``adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=float32)``, written
out as plain tensor arithmetic in optax's order:

    mu  = (1 - b1) * g + b1 * mu              # scale_by_adam
    nu  = (1 - b2) * g**2 + b2 * nu
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    u   = u + weight_decay * p                # add_decayed_weights, every leaf
    p   = p - lr * u                          # scale_by_learning_rate

Its state is ``AdamState(count, mu, nu)``, shaped like optax's
``ScaleByAdamState``, so a JAX state carries across one to one
(``convert.train_state_from_jax``).  JAX donates the state to the jitted
step; here ``step_fn`` updates it IN PLACE and returns the same tensors.

Not ported yet: a mesh and context / pipeline parallelism (ROADMAP A11),
gradient compression and overlapped gradient sync (A10), a custom
``optimizer=`` or ``loss=`` (A15, A11).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.ops.attention import flash_config_refusal

ADAMW_B1, ADAMW_B2, ADAMW_EPS, ADAMW_WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Any
    opt_state: Any


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: count (int32 scalar), and mu / nu shaped
    like the params (mu in fp32: the builder's ``mu_dtype``)."""
    count: torch.Tensor
    mu: Any
    nu: Any


def tree_leaves(tree) -> list:
    """Leaves of a nested dict of tensors, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tensors))


def adamw_init(params) -> AdamState:
    dev = tree_leaves(params)[0].device
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamState, learning_rate: float,
                 b1: float = ADAMW_B1, b2: float = ADAMW_B2,
                 eps: float = ADAMW_EPS,
                 weight_decay: float = ADAMW_WEIGHT_DECAY) -> None:
    """One AdamW step, in place on ``params`` and ``state`` (the count is
    incremented in place as well)."""
    state.count.add_(1)
    t = state.count.float()
    bc1 = 1 - b1 ** t  # fp32 on the device: no host sync
    bc2 = 1 - b2 ** t
    for p, g, mu, nu in zip(tree_leaves(params), grads,
                            tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(mu.dtype)
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square().to(nu.dtype), alpha=1 - b2)
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + eps)
        u.add_(p.to(u.dtype), alpha=weight_decay)
        p.add_(u.to(p.dtype), alpha=-learning_rate)


def _model_module(cfg):
    """Model-family dispatch: each module exposes init_params /
    train_param_dtypes / loss_fn / flops_per_token."""
    if isinstance(cfg, moe.MoEConfig):
        return moe
    if isinstance(cfg, llama.LlamaConfig):
        return llama
    raise TypeError(f"make_train_step takes a LlamaConfig or an MoEConfig "
                    f"(got {type(cfg).__name__})")


def make_train_step(cfg, mesh=None, *, optimizer=None,
                    learning_rate: float = 3e-4, context_parallel: bool = False,
                    loss: Optional[Callable] = None,
                    pipeline_microbatches: Optional[int] = None,
                    grad_compression=None, overlap_grad_sync: bool = False,
                    bucket_bytes: int = 4 << 20, device=None) -> tuple:
    """Returns (init_fn, step_fn) for a ``LlamaConfig`` or an ``MoEConfig``.

    init_fn(generator) -> TrainState: random params (the family's
    ``init_params``, stored as its ``train_param_dtypes`` say: fp32 master
    weights by default) and a zero AdamW state, on ``device`` (default
    CUDA; without a GPU that raises -- pass ``device="cpu"``).
    step_fn(state, tokens) -> (TrainState, metrics dict): metrics "loss",
    "grad_norm" (of the grads before the update) and "step", as 0-dim
    tensors on the device.  The state is updated in place.

    The other keywords exist for the JAX signature and raise when set
    (``bucket_bytes`` is read only with ``overlap_grad_sync``, as in the
    JAX builder).  A config whose attention would reach a flash kernel
    that is not built (``ops.attention.flash_config_refusal``) raises
    before any step."""
    model = _model_module(cfg)
    if mesh is not None or context_parallel or pipeline_microbatches is not None:
        raise NotImplementedError(
            "mesh / context_parallel / pipeline_microbatches (sharded, ring-"
            "attention and pipelined training) are not ported to "
            "ray_tpu_torch yet (ROADMAP A11)")
    if grad_compression is not None or overlap_grad_sync:
        raise NotImplementedError(
            "grad_compression / overlap_grad_sync (compressed and bucketed "
            "gradient sync) are not ported to ray_tpu_torch yet (ROADMAP A10)")
    if optimizer is not None:
        raise NotImplementedError(
            "a custom optimizer= is not ported to ray_tpu_torch yet "
            "(ROADMAP A15); the default AdamW is")
    if loss is not None:
        raise NotImplementedError(
            "a custom loss= (the pipeline losses) is not ported to "
            "ray_tpu_torch yet (ROADMAP A11)")
    llama._check_training(cfg, None, False)  # remat policy, early
    refusal = flash_config_refusal(cfg, "cuda" if device is None else device)
    if refusal:
        raise NotImplementedError(f"make_train_step: {refusal}")
    dev = resolve_device(device)
    rope = llama.rope_cache(cfg, cfg.max_seq_len, dev)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = model.init_params(cfg, generator, dev,
                                   model.train_param_dtypes(cfg))
        return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                          params, adamw_init(params))

    def step_fn(state: TrainState, tokens: torch.Tensor):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss_val = model.loss_fn(cfg, state.params, tokens,
                                     rope_cache=rope)
            grads = torch.autograd.grad(loss_val, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grad_norm = global_norm(grads)
        adamw_update(state.params, grads, state.opt_state, learning_rate)
        state.step.add_(1)
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss_val.detach(), "grad_norm": grad_norm,
            "step": state.step.clone()}
        return state, metrics

    return init_fn, step_fn

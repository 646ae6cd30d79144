"""Training-step builder for the Llama and MoE families, on one device.

Port of ``ray_tpu/parallel/train_step.py:make_train_step`` without a mesh:
``init_fn(generator) -> TrainState`` and ``step_fn(state, tokens) ->
(state, metrics)``.  The optimizer is a description (``parallel.optim``):
``optim.adamw(...)`` with optax's signature, by default the JAX builder's
``adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=float32)``.
``grad_compression`` chains the int8 block codec
(``util.collective.compression.compress_gradients``) before it, as the JAX
builder chains its optax transform; ``grad_norm`` stays the norm of the
uncompressed gradients.

The optimizer state nests as optax's chain: ``(AdamState, EmptyState,
EmptyState)``, under compression ``(EmptyState or ResidualState, (AdamState,
EmptyState, EmptyState))``.  So a JAX state carries across leaf for leaf
(``convert``), and a snapshot's keys are the JAX package's.  JAX donates the
state to the jitted step; here ``step_fn`` updates it IN PLACE and returns
the same tensors.

Not ported yet: a mesh and context / pipeline parallelism (ROADMAP A11),
overlapped gradient sync (A10), a custom ``loss=`` (A11).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.ops.attention import flash_config_refusal
from ray_tpu_torch.parallel.optim import AdamW, adamw


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Any
    opt_state: Any


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tensors))


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
    weights by default, ``cfg.param_dtype`` throughout) and the optimizer's
    zero state, on ``device`` (default CUDA; without a GPU that raises --
    pass ``device="cpu"``).
    step_fn(state, tokens) -> (TrainState, metrics dict): metrics "loss",
    "grad_norm" (of the grads before compression and the update) and
    "step", as 0-dim tensors on the device.  The state is updated in place.

    ``optimizer`` is None (the JAX builder's default AdamW, at
    ``learning_rate``) or an ``optim.adamw(...)`` description, which
    carries its own learning rate.  ``grad_compression`` ('int8', 'none',
    a dict of ``CompressionSpec`` fields or a spec) codes each gradient
    leaf before the optimizer.  The other keywords exist for the JAX
    signature and raise when set (``bucket_bytes`` is read only with
    ``overlap_grad_sync``, as in the JAX builder).  A config whose
    attention would reach a flash kernel that is not built
    (``ops.attention.flash_config_refusal``) raises before any step."""
    model = _model_module(cfg)
    if mesh is not None or context_parallel or pipeline_microbatches is not None:
        raise NotImplementedError(
            "mesh / context_parallel / pipeline_microbatches (sharded, ring-"
            "attention and pipelined training) are not ported to "
            "ray_tpu_torch yet (ROADMAP A11)")
    if overlap_grad_sync:
        raise NotImplementedError(
            "overlap_grad_sync (bucketed gradient sync behind per-bucket "
            "barriers) is not ported to ray_tpu_torch yet (ROADMAP A10)")
    if loss is not None:
        raise NotImplementedError(
            "a custom loss= (the pipeline losses) is not ported to "
            "ray_tpu_torch yet (ROADMAP A11)")
    if optimizer is None:
        optimizer = adamw(learning_rate, b1=0.9, b2=0.95, weight_decay=0.1,
                          mu_dtype=torch.float32)
    if not isinstance(optimizer, AdamW):
        raise TypeError(
            f"make_train_step takes optimizer=None or an optimizer description "
            f"from ray_tpu_torch.parallel.optim.adamw (got "
            f"{type(optimizer).__name__})")
    compress = None
    if grad_compression is not None:
        from ray_tpu_torch.util.collective.compression import compress_gradients

        compress = compress_gradients(grad_compression)
    llama._check_training(cfg, None, False)  # remat policy, early
    refusal = flash_config_refusal(cfg, "cuda" if device is None else device)
    if refusal:
        raise NotImplementedError(f"make_train_step: {refusal}")
    dev = resolve_device(device)
    rope = llama.rope_cache(cfg, cfg.max_seq_len, dev)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = model.init_params(cfg, generator, dev,
                                   model.train_param_dtypes(cfg))
        opt_state = optimizer.init(params)
        if compress is not None:
            opt_state = (compress.init(params), opt_state)
        return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                          params, opt_state)

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
        opt_state = state.opt_state
        if compress is not None:
            grads = compress.update(grads, opt_state[0])
            opt_state = opt_state[1]
        optimizer.update(state.params, grads, opt_state)
        state.step.add_(1)
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss_val.detach(), "grad_norm": grad_norm,
            "step": state.step.clone()}
        return state, metrics

    return init_fn, step_fn

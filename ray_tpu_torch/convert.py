"""Weight bridge: the JAX package's Llama and MoE params and training
states into the port's, and back.

``ray_tpu.models.llama.init_params`` and ``ray_tpu.models.moe.init_params``
return pytrees with the layers stacked on a leading axis and every
projection oriented for ``x @ w`` (MoE experts [L, E, d, f], the router
[L, d, E] in fp32); the port keeps all of it, so the bridge is a copy per
leaf (and a cast to the port's storage dtype), never a transpose.  The
pytree arrives as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module imports no JAX either; the torch -> JAX direction returns numpy
pytrees the JAX package takes (``jax.tree.map(jnp.asarray, ...)``), bf16 as
``ml_dtypes.bfloat16``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.host_arrays import from_numpy, to_numpy
from ray_tpu_torch._private.tree import tree_map, tree_map_with_keys
from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.llama import Params, param_dtypes

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_MOE_LAYER_KEYS = _LAYER_KEYS + ("router",)
# leaves that keep their own storage dtype when `dtype` overrides the rest
_OWN_DTYPE = ("attn_norm", "mlp_norm", "final_norm", "router")


def params_from_jax(np_params: Dict[str, Any], cfg, device=None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The port's params from the JAX package's (as numpy arrays), for a
    ``LlamaConfig`` or an ``MoEConfig``.

    Llama leaves are stored as ``models.llama.param_dtypes`` says:
    embedding, head and projections in ``cfg.compute_dtype`` (the JAX
    programs cast each to it right before its product, so this is the same
    arithmetic), norm weights in ``cfg.param_dtype``.  MoE leaves (MoE is
    trained, never served) as ``models.moe.train_param_dtypes`` says:
    ``cfg.param_dtype``, the router fp32.  ``dtype`` overrides the storage
    dtype of the embedding, head and projections.  With
    ``cfg.tie_embeddings`` there is no ``lm_head``: the head is
    ``embed.T``.  ``device`` None means CUDA, and raises without a GPU, as
    every entry point of the port (``llm.engine.resolve_device``)."""
    device = resolve_device(device)
    is_moe = isinstance(cfg, moe.MoEConfig)
    dts = moe.train_param_dtypes(cfg) if is_moe else param_dtypes(cfg)
    if dtype is not None:
        dts = {k: (v if k in _OWN_DTYPE else dtype) for k, v in dts.items()}
    has_head = "lm_head" in np_params
    tie = getattr(cfg, "tie_embeddings", False)
    if has_head == tie:
        raise ValueError(
            f"tie_embeddings={tie} but the params "
            f"{'have' if has_head else 'lack'} an lm_head")
    layers = np_params["layers"]
    keys = _MOE_LAYER_KEYS if is_moe else _LAYER_KEYS
    out: Params = {
        "embed": from_numpy(np_params["embed"], device, dts["embed"]),
        "layers": {k: from_numpy(layers[k], device, dts[k]) for k in keys},
        "final_norm": from_numpy(np_params["final_norm"], device,
                                 dts["final_norm"]),
    }
    if has_head:
        out["lm_head"] = from_numpy(np_params["lm_head"], device, dts["lm_head"])
    L, d, f = cfg.n_layers, cfg.dim, cfg.ffn_dim
    expect = {"embed": (cfg.vocab_size, d),
              "wq": (L, d, cfg.n_heads * cfg.head_dim)}
    if is_moe:
        e = cfg.n_experts
        expect.update(router=(L, d, e), w_gate=(L, e, d, f), w_up=(L, e, d, f),
                      w_down=(L, e, f, d))
    else:
        expect.update(w_gate=(L, d, f), w_down=(L, f, d))
    for name, shape in expect.items():
        got = tuple((out if name == "embed" else out["layers"])[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, config wants {shape}")
    return out


def lora_from_jax(np_adapter: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's LoRA adapter (``llm.lora``) from the JAX package's (as
    numpy arrays: ``jax.tree.map(np.asarray, adapter)``): each target's A
    [L, r, d_in] and B [L, d_out, r] copied in their own dtype, and the
    config dict.  ``device`` None means CUDA, and raises without a GPU."""
    device = resolve_device(device)
    layers = {name: {part: from_numpy(ab[part], device, None)
                     for part in ("A", "B")}
              for name, ab in np_adapter["layers"].items()}
    cfg = dict(np_adapter["config"])
    cfg["targets"] = tuple(cfg["targets"])
    return {"layers": layers, "config": cfg}


def train_state_from_jax(np_state, cfg, device=None):
    """The port's ``TrainState`` from the JAX package's (as numpy arrays:
    ``jax.tree.map(np.asarray, state)``), for a ``LlamaConfig`` or an
    ``MoEConfig``.

    Params are stored in ``cfg.param_dtype`` throughout (training keeps
    fp32 master weights by default; ``forward`` casts at each product), but
    for the MoE router, which stays fp32.  The optimizer state keeps optax's
    chain nesting, with and without gradient compression: each
    ``ScaleByAdamState`` becomes an ``AdamState`` (count, mu and nu in their
    own dtypes: mu in the ``mu_dtype`` it was made with, nu in the params'),
    an ``EmptyState`` an ``EmptyState``, and the error-feedback state its
    fp32 residual (``ResidualState``).  ``device`` None means CUDA, and
    raises without a GPU."""
    device = resolve_device(device)
    from ray_tpu_torch.parallel.optim import AdamState, EmptyState, find_adam_state
    from ray_tpu_torch.parallel.train_step import TrainState
    from ray_tpu_torch.util.collective.compression import ResidualState

    step, np_params, opt_state = np_state
    if find_adam_state(opt_state) is None:
        raise ValueError("the optimizer state holds no ScaleByAdamState "
                         "(count, mu, nu): only adamw, chained after the "
                         "gradient codec or not, carries over")

    def own(tree):  # a params-like tree, each leaf in its own dtype
        return tree_map(lambda a: from_numpy(a, device, None), tree)

    def node(s):
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            return AdamState(from_numpy(s.count, device, torch.int32),
                             own(s.mu), own(s.nu))
        if hasattr(s, "residual"):
            return ResidualState(own(s.residual))
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(node(c) for c in s)
        if isinstance(s, tuple) and len(s) == 0:
            return EmptyState()
        raise ValueError(f"optimizer state node {type(s).__name__} does not "
                         f"carry over (adamw and the gradient codec do)")

    params = tree_map(lambda t: t.to(cfg.param_dtype),
                      params_from_jax(np_params, cfg, device,
                                      dtype=cfg.param_dtype))
    if "router" in params["layers"]:
        params["layers"]["router"] = from_numpy(
            np_params["layers"]["router"], device, torch.float32)
    return TrainState(from_numpy(step, device, torch.int32), params,
                      node(opt_state))


def _host_copy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor that the state's later in-place
    updates cannot reach."""
    return to_numpy(t.detach().to("cpu", dtype=dtype, copy=True))


def params_to_jax(params: Params, cfg) -> Dict[str, Any]:
    """The JAX package's params (numpy) from the port's: the same pytree,
    each leaf cast to the JAX package's storage dtype (``cfg.param_dtype``;
    the MoE router fp32), so serving params (stored in the compute dtype)
    come back as the JAX package keeps them."""
    return tree_map_with_keys(
        lambda key, t: _host_copy(t, torch.float32 if key.endswith("router")
                                  else cfg.param_dtype), params)


def train_state_to_jax(state):
    """The JAX package's ``TrainState`` from the port's, as numpy arrays in
    its exact structure: (step, params, opt_state) with optax's chain
    nesting, under NamedTuples whose fields are optax's (``count/mu/nu``,
    ``residual``), so ``jax.tree_util`` key paths and leaf order are the
    JAX state's.  Every leaf keeps its dtype.  Feed it to a JAX step with
    ``jax.tree.map(jnp.asarray, ...)``."""
    return tree_map(_host_copy, state)

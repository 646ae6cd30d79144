"""Weight bridge: the JAX package's Llama and MoE params into the port's.

``ray_tpu.models.llama.init_params`` and ``ray_tpu.models.moe.init_params``
return pytrees with the layers stacked on a leading axis and every
projection oriented for ``x @ w`` (MoE experts [L, E, d, f], the router
[L, d, E] in fp32); the port keeps all of it, so the bridge is a copy per
leaf (and a cast to the port's storage dtype), never a transpose.  The
pytree arrives as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module imports no JAX either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.llama import Params, param_dtypes

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_MOE_LAYER_KEYS = _LAYER_KEYS + ("router",)
# leaves that keep their own storage dtype when `dtype` overrides the rest
_OWN_DTYPE = ("attn_norm", "mlp_norm", "final_norm", "router")


def _tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.array(arr)  # a writable contiguous copy: torch shares its memory
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


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
        "embed": _tensor(np_params["embed"], device, dts["embed"]),
        "layers": {k: _tensor(layers[k], device, dts[k]) for k in keys},
        "final_norm": _tensor(np_params["final_norm"], device,
                              dts["final_norm"]),
    }
    if has_head:
        out["lm_head"] = _tensor(np_params["lm_head"], device, dts["lm_head"])
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
    layers = {name: {part: _tensor(ab[part], device, None)
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
    fp32 master weights; ``forward`` casts at each product), but for the
    MoE router, which stays fp32.  optax's adamw state is a tuple whose
    ``ScaleByAdamState`` carries count, mu and nu; they become the port's
    ``AdamState`` (mu fp32, nu in the params' dtype, as optax keeps
    them).  ``device`` None means CUDA, and raises without a GPU."""
    device = resolve_device(device)
    from ray_tpu_torch.parallel.train_step import AdamState, TrainState, tree_map

    step, np_params, opt_state = np_state
    adam = next((s for s in (opt_state if isinstance(opt_state, (tuple, list))
                             else (opt_state,))
                 if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("the optimizer state holds no ScaleByAdamState "
                         "(count, mu, nu): only the default adamw carries over")

    def leaves(tree, dtype):
        out = tree_map(lambda t: t.to(dtype),
                       params_from_jax(tree, cfg, device, dtype=dtype))
        if "router" in out["layers"]:
            out["layers"]["router"] = _tensor(tree["layers"]["router"],
                                              device, torch.float32)
        return out

    return TrainState(
        _tensor(step, device, torch.int32),
        leaves(np_params, cfg.param_dtype),
        AdamState(_tensor(adam.count, device, torch.int32),
                  leaves(adam.mu, torch.float32),
                  leaves(adam.nu, cfg.param_dtype)))

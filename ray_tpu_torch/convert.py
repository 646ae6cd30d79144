"""Weight bridge: the JAX package's Llama params into the port's.

``ray_tpu.models.llama.init_params`` returns a pytree with the layers
stacked on a leading axis and every projection oriented for ``x @ w``; the
port keeps both, so the bridge is a copy per leaf (and a cast to the
port's storage dtype), never a transpose.  The pytree arrives as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module imports no
JAX either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, Params, param_dtypes

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def _tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.array(arr)  # a writable contiguous copy: torch shares its memory
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: Dict[str, Any], cfg: LlamaConfig,
                    device="cpu", dtype: Optional[torch.dtype] = None) -> Params:
    """The port's params from the JAX package's (as numpy arrays).

    Leaves are stored as ``models.llama.param_dtypes`` says: embedding,
    head and projections in ``cfg.compute_dtype`` (the JAX programs cast
    each to it right before its product, so this is the same arithmetic),
    norm weights in ``cfg.param_dtype``.  ``dtype`` overrides the storage
    dtype of the embedding, head and projections.  With
    ``cfg.tie_embeddings`` there is no ``lm_head``: the head is
    ``embed.T``."""
    dts = param_dtypes(cfg)
    if dtype is not None:
        dts = {k: (v if k.endswith("norm") else dtype) for k, v in dts.items()}
    has_head = "lm_head" in np_params
    if has_head == cfg.tie_embeddings:
        raise ValueError(
            f"tie_embeddings={cfg.tie_embeddings} but the params "
            f"{'have' if has_head else 'lack'} an lm_head")
    layers = np_params["layers"]
    out: Params = {
        "embed": _tensor(np_params["embed"], device, dts["embed"]),
        "layers": {k: _tensor(layers[k], device, dts[k]) for k in _LAYER_KEYS},
        "final_norm": _tensor(np_params["final_norm"], device,
                              dts["final_norm"]),
    }
    if has_head:
        out["lm_head"] = _tensor(np_params["lm_head"], device, dts["lm_head"])
    expect = {"embed": (cfg.vocab_size, cfg.dim),
              "wq": (cfg.n_layers, cfg.dim, cfg.n_heads * cfg.head_dim)}
    for name, shape in expect.items():
        got = tuple((out if name == "embed" else out["layers"])[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, config wants {shape}")
    return out

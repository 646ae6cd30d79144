"""LoRA adapters for the Llama family (port of ``ray_tpu/llm/lora.py``).

An adapter holds a pair (A [L, r, d_in], B [L, d_out, r]) per targeted
projection, stacked on the layer axis like the base params.  Serving merges
it into the base weights, W' = W + scale * (B A)^T, so the engine's decode
programs run unchanged; a ``LoRAManager`` keeps an LRU of merged params per
adapter name.

Rounding of the merge: the port stores serving projections in
``cfg.compute_dtype`` (``models.llama.param_dtypes``), while the JAX
package merges into its fp32 params and casts at each use.  ``merge_lora``
therefore adds in fp32 from the stored weight and rounds once:
W' = round(float(W) + scale * (B A)^T).  That equals the JAX package's
merged weight at its use exactly whenever the JAX base weights are
representable in the stored dtype (always at fp32).

``lora_param_specs`` gives an adapter's partition specs (rank dims
replicated, model dims following the base layout); a tensor-parallel
engine serves a merged adapter as it serves any params, sharded by
``models.llama.inference_param_specs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.models.llama import LlamaConfig

# base-params leaf names an adapter may target (the layers subtree)
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = ("wq", "wv")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _projection_shape(cfg: LlamaConfig, name: str):
    """(d_in, d_out) of a layer projection, as ``init_params`` makes it."""
    d, f = cfg.dim, cfg.ffn_dim
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    return {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}[name]


def init_lora(cfg: LlamaConfig, lora: LoRAConfig, generator: torch.Generator,
              dtype: torch.dtype = torch.float32, device=None
              ) -> Dict[str, Any]:
    """A-matrices gaussian (std 0.02), B zero (an adapter starts as the
    identity), stacked on the layer axis; drawn from ``generator`` on
    ``device`` (default: the generator's device).  The numbers differ from
    the JAX package's for the same seed; ``convert.lora_from_jax`` carries
    a JAX adapter over."""
    device = generator.device if device is None else device
    out: Dict[str, Any] = {"layers": {}}
    for name in lora.targets:
        if name not in TARGETS:
            raise ValueError(
                f"unknown LoRA target {name!r}; choose from {TARGETS}")
        d_in, d_out = _projection_shape(cfg, name)
        a = torch.empty((cfg.n_layers, lora.rank, d_in), dtype=dtype,
                        device=device).normal_(0.0, 0.02, generator=generator)
        out["layers"][name] = {
            "A": a,
            "B": torch.zeros((cfg.n_layers, d_out, lora.rank), dtype=dtype,
                             device=device),
        }
    out["config"] = dataclasses.asdict(lora)
    return out


def merge_lora(params: Dict[str, Any], adapter: Dict[str, Any]) -> Dict[str, Any]:
    """Params with W' = round(float(W) + scale * (B A)^T) per targeted
    projection, rounded once to W's dtype (see the module docstring).

    Functional: untargeted leaves are the base's own tensors, so N merged
    adapters cost N x the targeted matrices, not N models."""
    lcfg = LoRAConfig(**adapter["config"])
    new_layers = dict(params["layers"])
    for name, ab in adapter["layers"].items():
        w = params["layers"][name]
        # A: [L, r, d_in], B: [L, d_out, r] -> delta^T: [L, d_in, d_out]
        delta = torch.einsum("lor,lri->lio", ab["B"].float(),
                             ab["A"].float()) * lcfg.scale
        new_layers[name] = (w.float() + delta.to(w.device)).to(w.dtype)
    out = dict(params)
    out["layers"] = new_layers
    return out


def adapter_speculation(spec_cfg, model_id: Optional[str]):
    """Resolve speculative decoding for one multi-LoRA model id (the
    per-adapter draft choice, ``SpeculativeConfig.per_adapter``).

    Returns ``(effective_spec_cfg, draft_adapter)``:
      - ``(None, None)``: no speculation for this adapter (no global
        config, an ``{"enabled": False}`` override, or an explicit
        ``num_speculative_tokens`` below 1);
      - ``(cfg, None)``: the global config, possibly with a per-adapter
        ``num_speculative_tokens``;
      - ``(cfg, adapter)``: also merge ``adapter`` (a LoRA tree for the
        DRAFT model) into the draft weights for this id, so a tuned target
        keeps an aligned draft."""
    if spec_cfg is None:
        return None, None
    over = (spec_cfg.per_adapter or {}).get(model_id) if model_id else None
    if not over:
        return spec_cfg, None
    if not over.get("enabled", True):
        return None, None
    eff = spec_cfg
    k = over.get("num_speculative_tokens")
    if k is not None:
        if int(k) < 1:
            # an explicit 0 means "do not speculate for this adapter"
            return None, None
        eff = dataclasses.replace(spec_cfg, num_speculative_tokens=int(k))
    return eff, over.get("draft_adapter")


def lora_param_specs(cfg: LlamaConfig, lora: LoRAConfig):
    """Partition-spec tree for adapter params (one mesh-axis name or None
    per dim): rank dims replicated (tiny), model dims following the base's
    training layout (``models.llama.param_specs``), so merges stay local."""
    from ray_tpu_torch.models import llama

    base = llama.param_specs(cfg)["layers"]
    out = {"layers": {}, "config": None}
    for name in lora.targets:
        bspec = base[name]  # (None, in_axis, out_axis)
        out["layers"][name] = {
            "A": (None, None, bspec[1]),
            "B": (None, bspec[2], None),
        }
    return out


def trainable_mask(params: Dict[str, Any], adapter: Dict[str, Any]):
    """Mask trees ``(adapter_mask, base_mask)``: True on every adapter
    leaf (its config False), False on every base leaf -- for
    parameter-efficient finetuning, where only A and B update."""
    adapter_mask = tree_map(lambda _: True, adapter)
    adapter_mask["config"] = False
    base_mask = tree_map(lambda _: False, params)
    return adapter_mask, base_mask


class LoRAManager:
    """Adapter registry and an LRU of merged params for a serving replica."""

    def __init__(self, base_params: Dict[str, Any], max_merged: int = 4):
        self._base = base_params
        self._adapters: Dict[str, Dict[str, Any]] = {}
        self._merged: Dict[str, Dict[str, Any]] = {}
        self._order: list = []
        self._max = max_merged

    def register(self, name: str, adapter: Dict[str, Any]):
        self._adapters[name] = adapter
        self._merged.pop(name, None)
        if name in self._order:
            self._order.remove(name)

    def adapter_names(self):
        return sorted(self._adapters)

    def params_for(self, name: Optional[str]) -> Dict[str, Any]:
        """The base params for None or an unknown name; merged params
        (cached, least recently used evicted) for an adapter."""
        if not name or name not in self._adapters:
            return self._base
        cached = self._merged.get(name)
        if cached is not None:
            self._order.remove(name)
            self._order.append(name)
            return cached
        merged = merge_lora(self._base, self._adapters[name])
        self._merged[name] = merged
        self._order.append(name)
        while len(self._order) > self._max:
            evict = self._order.pop(0)
            self._merged.pop(evict, None)
        return merged

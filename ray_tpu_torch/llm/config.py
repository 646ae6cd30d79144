"""LLM configs (port of ``ray_tpu/llm/config.py``).

The fields are the JAX package's, so a config reads the same in both
packages.  The values this slice of the port does not serve raise
``NotImplementedError`` naming the ROADMAP item that will bring them
(:func:`check_supported`); nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → disabled
    seed: int = 0
    stop_token_ids: tuple = ()


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft-model speculative decoding (paged engine only).

    A small draft model proposes ``num_speculative_tokens`` tokens per slot
    per step; the target verifies all of them in ONE window forward
    (rejection sampling at temperature > 0; exact longest-agreeing-prefix
    at temperature 0, so greedy output equals non-speculative decode's).
    The draft's KV lives in its own block pool; draft-pool exhaustion
    degrades the affected request to plain decode (zero drops)."""

    # a models.llama.LlamaConfig for the draft (same vocab as the target)
    draft_model_config: Any = None
    # k: drafted tokens verified per target forward, per slot per step;
    # each step emits 1 (all rejected) to k+1 (all accepted + the bonus)
    num_speculative_tokens: int = 4
    # draft KV pool size in blocks; None -> the target pool's block count
    draft_num_blocks: Optional[int] = None
    # per-adapter draft choice for multi-LoRA serving, {model id:
    # overrides}; resolved by ``llm.lora.adapter_speculation`` where an
    # adapter's engine is built (LLMServer, ROADMAP A8), never by an engine
    per_adapter: Optional[Dict[str, Dict[str, Any]]] = None


@dataclasses.dataclass
class LLMConfig:
    """Engine config, with the JAX package's fields and defaults."""

    model_config: Any = None  # a models.llama.LlamaConfig
    max_batch_size: int = 8
    # tokens decoded per dispatch (multi-step scheduling): the whole chunk
    # runs on the device with stop/budget handling there, so the host reads
    # back once per `decode_chunk` tokens.  1 = sync every token.
    decode_chunk: int = 8
    max_seq_len: Optional[int] = None  # default: model_config.max_seq_len
    # "paged" (block pool) or "static" (one max_seq stripe per slot)
    kv_cache: str = "paged"
    block_size: int = 16
    # pool size in blocks; None → half the memory a static cache would use
    num_blocks: Optional[int] = None
    # prompt tokens prefilled per step (multiple of block_size)
    prefill_chunk: int = 256
    # prompt tokens the engine may prefill per STEP across all slots;
    # None = prefill_chunk
    prefill_token_budget: Optional[int] = None
    # deprecated alias for prefill_token_budget; the new knob wins
    prefill_budget_tokens: Optional[int] = None
    speculative_config: Optional[Any] = None
    enable_prefix_caching: bool = True
    # host-RAM prefix tier (paged engine): pool evictions of cached prompt
    # blocks demote here, byte-capped LRU; 0 disables
    host_kv_cache_bytes: int = 64 * 1024 * 1024
    plasma_kv_cache_blocks: int = 0
    # None = the CUDA paged-attention kernel where supported (a CUDA device,
    # bf16 pool, a compiled head_dim/GQA group); True forces it (raises
    # where unsupported, e.g. on the CPU); False forces the table gather
    paged_attention_kernel: Optional[Any] = None
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    mesh: Optional[Any] = None
    tp_planned_collectives: bool = True
    tp_overlap_collectives: bool = True
    tp_collective_algorithm: Optional[str] = None
    # serving
    num_replicas: int = 1
    chips_per_replica: Optional[int] = None


# value -> ROADMAP item that ports it
_UNPORTED: Dict[str, str] = {
    "speculative_config.per_adapter": "A8 (LLMServer's per-adapter engines)",
    "tensor_parallel_size > 1": "A11 (multi-device model parallel)",
    "pipeline_parallel_size > 1": "A11 (multi-device model parallel)",
    "data_parallel_size > 1": "A11 (multi-device model parallel)",
    "mesh": "A11 (multi-device model parallel)",
    "plasma_kv_cache_blocks > 0": "A16 (the object store's prefix tier)",
}


def check_supported(config: LLMConfig) -> None:
    """Raise ``NotImplementedError`` for a value this slice does not serve."""
    hits = {
        "speculative_config.per_adapter": bool(
            getattr(config.speculative_config, "per_adapter", None)),
        "tensor_parallel_size > 1": config.tensor_parallel_size > 1,
        "pipeline_parallel_size > 1": config.pipeline_parallel_size > 1,
        "data_parallel_size > 1": config.data_parallel_size > 1,
        "mesh": config.mesh is not None,
        "plasma_kv_cache_blocks > 0": config.plasma_kv_cache_blocks > 0,
    }
    for what, hit in hits.items():
        if hit:
            raise NotImplementedError(
                f"LLMConfig {what} is not ported to ray_tpu_torch yet "
                f"(ROADMAP {_UNPORTED[what]})")

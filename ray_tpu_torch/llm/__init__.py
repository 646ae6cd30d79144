"""LLM serving engines of the port: the paged and the static engine, their
configs (speculative decoding among them), and LoRA adapters."""

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.llm.engine import TorchLLMEngine, make_engine
from ray_tpu_torch.llm.lora import (
    LoRAConfig,
    LoRAManager,
    adapter_speculation,
    init_lora,
    merge_lora,
)
from ray_tpu_torch.llm.paged import (
    BlockAllocator,
    BlockManager,
    PagedTorchLLMEngine,
)

__all__ = [
    "BlockAllocator",
    "BlockManager",
    "GenerationConfig",
    "LLMConfig",
    "LoRAConfig",
    "LoRAManager",
    "PagedTorchLLMEngine",
    "SpeculativeConfig",
    "TorchLLMEngine",
    "adapter_speculation",
    "init_lora",
    "make_engine",
    "merge_lora",
]

"""LLM serving of the port: the paged and the static engine, their configs
(speculative decoding among them), LoRA adapters, and the in-process
serving classes over them (``LLMServer``, ``OpenAICompatServer``, and the
disaggregated ``PrefillServer``/``DecodeServer``)."""

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.llm.disagg import DecodeServer, PrefillServer
from ray_tpu_torch.llm.engine import TorchLLMEngine, make_engine
from ray_tpu_torch.llm.lora import (
    LoRAConfig,
    LoRAManager,
    adapter_speculation,
    init_lora,
    merge_lora,
)
from ray_tpu_torch.llm.openai_api import ByteTokenizer, OpenAICompatServer
from ray_tpu_torch.llm.paged import (
    BlockAllocator,
    BlockManager,
    PagedTorchLLMEngine,
)
from ray_tpu_torch.llm.serve import LLMServer

__all__ = [
    "BlockAllocator",
    "BlockManager",
    "ByteTokenizer",
    "DecodeServer",
    "GenerationConfig",
    "LLMConfig",
    "LLMServer",
    "LoRAConfig",
    "LoRAManager",
    "OpenAICompatServer",
    "PagedTorchLLMEngine",
    "PrefillServer",
    "SpeculativeConfig",
    "TorchLLMEngine",
    "adapter_speculation",
    "init_lora",
    "make_engine",
    "merge_lora",
]

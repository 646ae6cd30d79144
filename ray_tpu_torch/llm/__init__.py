"""LLM serving of the port: the paged and the static engine, their configs
(speculative decoding among them), LoRA adapters, and the in-process
serving classes over them (``LLMServer``, ``OpenAICompatServer``, and the
disaggregated ``PrefillServer``/``DecodeServer`` behind ``DisaggLLMServer``),
and the builders that make them serve deployments (``build_llm_deployment``,
``build_openai_app``, ``build_disagg_llm_deployment``); batch inference over
a dataset (``build_llm_processor``)."""

from ray_tpu_torch.llm.batch import Processor, ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.llm.disagg import (
    DecodeServer,
    DisaggLLMServer,
    PrefillServer,
    build_disagg_llm_deployment,
)
from ray_tpu_torch.llm.engine import TorchLLMEngine, make_engine
from ray_tpu_torch.llm.lora import (
    LoRAConfig,
    LoRAManager,
    adapter_speculation,
    init_lora,
    merge_lora,
)
from ray_tpu_torch.llm.openai_api import (
    ByteTokenizer,
    OpenAICompatServer,
    build_openai_app,
)
from ray_tpu_torch.llm.paged import (
    BlockAllocator,
    BlockManager,
    PagedTorchLLMEngine,
)
from ray_tpu_torch.llm.serve import LLMServer, build_llm_deployment

__all__ = [
    "BlockAllocator",
    "BlockManager",
    "ByteTokenizer",
    "DecodeServer",
    "DisaggLLMServer",
    "GenerationConfig",
    "LLMConfig",
    "LLMServer",
    "LoRAConfig",
    "LoRAManager",
    "OpenAICompatServer",
    "PagedTorchLLMEngine",
    "PrefillServer",
    "Processor",
    "ProcessorConfig",
    "SpeculativeConfig",
    "TorchLLMEngine",
    "adapter_speculation",
    "build_disagg_llm_deployment",
    "build_llm_deployment",
    "build_llm_processor",
    "build_openai_app",
    "init_lora",
    "make_engine",
    "merge_lora",
]

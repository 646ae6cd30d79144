"""LLM serving engines of the port: the paged and the static engine, and
their configs."""

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.llm.engine import TorchLLMEngine, make_engine
from ray_tpu_torch.llm.paged import BlockManager, PagedTorchLLMEngine

__all__ = [
    "BlockManager",
    "GenerationConfig",
    "LLMConfig",
    "PagedTorchLLMEngine",
    "TorchLLMEngine",
    "make_engine",
]

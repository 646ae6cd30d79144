"""LLM serving engine of the port: the paged engine and its configs."""

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.llm.engine import make_engine
from ray_tpu_torch.llm.paged import BlockManager, PagedTorchLLMEngine

__all__ = [
    "BlockManager",
    "GenerationConfig",
    "LLMConfig",
    "PagedTorchLLMEngine",
    "make_engine",
]

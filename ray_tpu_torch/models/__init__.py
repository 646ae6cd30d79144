"""Model definitions of the port."""

from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.models.moe import MoEConfig

__all__ = ["LlamaConfig", "MoEConfig", "init_params"]

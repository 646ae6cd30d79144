"""Model definitions of the port."""

from ray_tpu_torch.models.llama import LlamaConfig, init_params

__all__ = ["LlamaConfig", "init_params"]

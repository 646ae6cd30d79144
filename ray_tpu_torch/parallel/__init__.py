"""Train-step builders of the port (``ray_tpu/parallel`` on one device;
meshes and pipelines are ROADMAP A11) and the optimizer descriptions they
take (``optim``)."""

from ray_tpu_torch.parallel.optim import adamw
from ray_tpu_torch.parallel.train_step import TrainState, make_train_step

__all__ = ["TrainState", "adamw", "make_train_step"]

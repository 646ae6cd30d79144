"""Train-step builders of the port (``ray_tpu/parallel`` on one device;
meshes and pipelines are ROADMAP A11)."""

from ray_tpu_torch.parallel.train_step import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step"]

"""Train v2 API: controller-process training (reference: ray.train.v2).

The v1 surface (ray_tpu_torch.train.TorchTrainer) runs its control loop in the
driver; v2 runs it in a controller ACTOR — detachable, re-attachable, with
live status — while reusing the same BackendExecutor/WorkerGroup/policies
underneath (reference: v2/api/data_parallel_trainer.py over
controller/controller.py:93).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.train.v2.controller import (
    TrainControllerActor,
    TrainControllerHandle,
)


class TorchTrainer:
    """v2 trainer: same constructor surface as v1's TorchTrainer, but fit()
    drives a controller actor. ``detached_name`` makes the controller a
    named detached actor so training survives the driver (re-join with
    ``TorchTrainer.attach(name)``)."""

    def __init__(self, train_loop_per_worker, *, detached_name: Optional[str] = None,
                 **trainer_kwargs):
        self._train_fn = train_loop_per_worker
        self._kwargs = trainer_kwargs
        self._detached_name = detached_name

    def _controller(self):
        import cloudpickle

        import ray_tpu_torch

        fn, kwargs = self._train_fn, self._kwargs

        def make_trainer():
            from ray_tpu_torch.train.trainer import TorchTrainer as V1TorchTrainer

            return V1TorchTrainer(fn, **kwargs)

        blob = cloudpickle.dumps(make_trainer)
        opts = {"num_cpus": 0.5, "max_concurrency": 4}
        if self._detached_name:
            opts.update(name=self._detached_name, lifetime="detached")
        actor_cls = ray_tpu_torch.remote(TrainControllerActor).options(**opts)
        return actor_cls.remote(blob)

    def fit(self):
        handle = self.fit_async()
        return handle.result()

    def fit_async(self) -> TrainControllerHandle:
        """Launch without blocking; poll ``handle.status()`` / await
        ``handle.result()`` (reference: v2 async controller execution)."""
        actor = self._controller()
        return TrainControllerHandle(actor, actor.run.remote())

    @staticmethod
    def attach(name: str) -> TrainControllerHandle:
        return TrainControllerHandle.attach(name)


__all__ = [
    "TorchTrainer",
    "TrainControllerActor",
    "TrainControllerHandle",
]

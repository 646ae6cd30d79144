"""Parallelism of the port: device meshes (``mesh``), the differentiable
collectives of sharded training (``functional``), the train-step builder
over a mesh (``train_step``), the GPipe pipeline loss (``pipeline``),
gradient buckets (``bucketing``) and the optimizer descriptions
(``optim``).

The names below load on first use, so the model modules can import
``parallel.functional`` without this package importing them back.
"""

import importlib

_EXPORTS = {
    "MESH_AXES": "mesh",
    "MeshSpec": "mesh",
    "batch_spec": "mesh",
    "local_mesh": "mesh",
    "TrainState": "train_step",
    "make_train_step": "train_step",
    "make_pipeline_loss": "pipeline",
    "pipeline_param_specs": "pipeline",
    "adamw": "optim",
}

_SUBMODULES = ("bucketing", "functional", "mesh", "optim", "pipeline",
               "train_step")

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)

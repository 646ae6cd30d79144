"""Backend plugin ABC + the torch backend.

reference: python/ray/train/backend.py — Backend :16 / BackendConfig :32 with
hooks on_start :45, on_training_start :53, on_shutdown :49; _TorchBackend
(torch/config.py:154): worker-0 address → dist.init_process_group on every
worker (:116).  The counterpart of the JAX package's JaxConfig/_JaxBackend
(``ray_tpu/train/backend.py``), which publishes worker 0's coordinator
address for jax.distributed.initialize.  Megascale (multislice) has no
counterpart here.

A train loop on a gang of N workers builds the port's mesh over the
process group's store, with no second address to pick:

    mesh = MeshSpec(data=N).build(rank=ctx.get_world_rank(),
                                  store=gang_store(), device=dev)
    init_fn, step_fn = make_train_step(cfg, mesh, device=dev)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_TIMEOUT_S = 300.0  # the process group's rendezvous and collective timeout


class BackendConfig:
    """Declarative config naming its Backend class (reference: backend.py:32)."""

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Gang-setup hooks around the worker group (reference: backend.py:16)."""

    def on_start(self, worker_group, backend_config: BackendConfig):  # noqa: B027
        pass

    def on_training_start(self, worker_group, backend_config: BackendConfig):  # noqa: B027
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig):  # noqa: B027
        pass


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """Config for torch.distributed gangs (reference: TorchConfig).

    backend: "nccl", "gloo", or None = NCCL where every worker holds a
    card, gloo otherwise.  NCCL refuses two ranks on one card: a gang of
    several workers sharing a card runs gloo.
    distributed: None = auto (a process group iff >1 worker); True/False
    force it.
    multislice: the JAX package's megascale setup; True refuses.
    """

    backend: Optional[str] = None
    distributed: Optional[bool] = None
    coordinator_port: Optional[int] = None
    multislice: Optional[bool] = None

    def __post_init__(self):
        if self.multislice:
            raise ValueError(
                "TorchConfig(multislice=True): megascale (DCN between TPU "
                "slices) has no counterpart in the port; one process group "
                "spans the gang")
        if self.backend not in (None, "nccl", "gloo"):
            raise ValueError(f"TorchConfig(backend={self.backend!r}): "
                             "'nccl', 'gloo' or None")

    @property
    def backend_cls(self):
        return _TorchBackend


def _pick_coordinator(port: Optional[int]):
    """This worker's address as the runtime serves it, and a free port.
    No outside host is asked."""
    import socket

    try:
        from ray_tpu_torch._private.worker import get_global_worker

        host = get_global_worker().address[0]
    except Exception:  # noqa: BLE001 — no runtime in this process
        host = "127.0.0.1"
    if port is None:
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
    return f"{host}:{port}"


def _card_info():
    """What a worker's lease bound: its card ids, and how many cards the
    process sees (0 without CUDA).  A worker that booked cards must see
    exactly those."""
    import torch

    import ray_tpu_torch

    ids = ray_tpu_torch.get_gpu_ids()
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ids and seen and seen != len(ids):
        raise RuntimeError(
            f"a worker leased cards {ids} but sees {seen} "
            "(CUDA_VISIBLE_DEVICES was not bound before CUDA started)")
    return {"gpu_ids": ids, "cuda_devices": seen}


def _init_torch_distributed(address: str, world_size: int, rank: int,
                            backend: str):
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(0)  # the first card the lease bound
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    return True


def _destroy_torch_distributed():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


def gang_store(prefix: str = "mesh"):
    """The gang's rendezvous store (the process group's), under ``prefix``:
    ``MeshSpec(...).build(store=gang_store())`` builds the port's mesh over
    it.  Use a fresh prefix per mesh a gang builds."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group in this worker: a gang of "
            "one worker has none unless TorchConfig(distributed=True)")
    return dist.PrefixStore(prefix, dist.distributed_c10d._get_default_store())


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        cards = worker_group.execute(_card_info)
        n = len(worker_group)
        distributed = backend_config.distributed
        if distributed is None:
            distributed = n > 1
        if not distributed:
            return
        backend = backend_config.backend
        if backend is None:
            backend = ("nccl" if all(c["gpu_ids"] and c["cuda_devices"]
                                     for c in cards) else "gloo")
        coordinator = worker_group.execute_single(
            0, _pick_coordinator, backend_config.coordinator_port)
        import ray_tpu_torch

        ray_tpu_torch.get([
            w._execute.remote(_init_torch_distributed, coordinator, n, i,
                              backend)
            for i, w in enumerate(worker_group.workers)
        ])

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        import ray_tpu_torch

        # a worker stuck in a collective with a dead peer must not hold
        # the gang's teardown: the executor kills the workers after this
        ray_tpu_torch.get(worker_group.execute_async(_destroy_torch_distributed),
                          timeout=30.0)

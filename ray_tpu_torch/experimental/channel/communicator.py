"""Communicator ABC for compiled-graph channels and device collectives.

reference: python/ray/experimental/channel/communicator.py:18 (Communicator
ABC — send :70, recv :86, allreduce :141) — the pluggable transport compiled
graphs use for tensor movement.  The port's implementation rides the
framework's collective groups: the nccl backend (NCCL for CUDA tensors,
gloo for CPU ones), or the store backend for host tensors anywhere.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ray_tpu_torch.util.collective.types import ReduceOp


class Communicator:
    """Transport contract for device-resident tensors between actors."""

    def get_rank(self) -> int:
        raise NotImplementedError

    def get_world_size(self) -> int:
        raise NotImplementedError

    def send(self, tensor, dst_rank: int) -> None:
        raise NotImplementedError

    def recv(self, src_rank: int):
        raise NotImplementedError

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        raise NotImplementedError

    def allgather(self, tensor):
        raise NotImplementedError

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        raise NotImplementedError

    def broadcast(self, tensor, src_rank: int = 0):
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def destroy(self) -> None:  # noqa: B027
        pass


class CollectiveGroupCommunicator(Communicator):
    """Communicator over a ray_tpu_torch.util.collective group (reference: the
    torch/cupy-backed communicators; here tensors are torch tensors and
    the backend decides the wire — NCCL between cards, the store
    actor across hosts)."""

    def __init__(self, world_size: int, rank: int, *,
                 backend: str = "store", group_name: str = "default"):
        from ray_tpu_torch.util import collective

        if not collective.is_group_initialized(group_name):
            collective.init_collective_group(world_size, rank,
                                             backend=backend,
                                             group_name=group_name)
        self._group_name = group_name
        self._collective = collective

    def get_rank(self) -> int:
        return self._collective.get_rank(self._group_name)

    def get_world_size(self) -> int:
        return self._collective.get_collective_group_size(self._group_name)

    def send(self, tensor, dst_rank: int) -> None:
        self._collective.send(tensor, dst_rank, group_name=self._group_name)

    def recv(self, src_rank: int):
        return self._collective.recv(src_rank, group_name=self._group_name)

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return self._collective.allreduce(tensor, group_name=self._group_name,
                                          op=op)

    def allgather(self, tensor):
        return self._collective.allgather(tensor,
                                          group_name=self._group_name)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return self._collective.reducescatter(
            tensor, group_name=self._group_name, op=op)

    def broadcast(self, tensor, src_rank: int = 0):
        return self._collective.broadcast(tensor, src_rank=src_rank,
                                          group_name=self._group_name)

    def barrier(self) -> None:
        self._collective.barrier(group_name=self._group_name)

    def destroy(self) -> None:
        try:
            self._collective.destroy_collective_group(self._group_name)
        except Exception:  # noqa: BLE001 — group may already be destroyed by a peer
            pass

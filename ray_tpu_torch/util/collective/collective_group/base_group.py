"""Collective group ABC.

reference: python/ray/util/collective/collective_group/base_collective_group.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List

from ray_tpu_torch.util.collective.types import ReduceOp


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name
        # per-group compression default (set by init_collective_group); a
        # per-call compression= overrides.  None = stock uncompressed path.
        self.default_compression = None
        # OpStats of the most recent compression-enabled op (None when the
        # stock path ran) — read by the API layer for metrics/spans.
        self.last_op_stats = None
        # host-side op counter for flight-recorder entry/exit marks: the
        # hang sweep compares members' last-entered (op, seq) to name the
        # member that never arrived
        self._fr_seq = 0

    def _mark(self, op: str, phase: str, seq: int = None):
        """Flight-recorder collective mark: (group, op, seq, member rank).
        ``enter`` is recorded BEFORE the op blocks, so a member wedged
        inside the collective still shows where it is."""
        from ray_tpu_torch._private import flight_recorder

        if seq is None:
            if phase == "enter":
                self._fr_seq += 1
            seq = self._fr_seq
        flight_recorder.record(
            "collective", f"{self._group_name}:{op}",
            f"{phase}:seq{seq}:rank{self._rank}/{self._world_size}")
        return seq

    def _topology_num_slices(self) -> int:
        """How many latency domains (TPU slices / hosts) the group spans —
        drives the hierarchical-algorithm auto policy.  Backends with real
        topology knowledge override."""
        return 1

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def group_name(self) -> str:
        return self._group_name

    def destroy(self):  # noqa: B027
        from ray_tpu_torch.util.collective import compression

        compression.error_feedback.clear_group(self._group_name)

    @abstractmethod
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM,
                  compression=None): ...

    @abstractmethod
    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM): ...

    @abstractmethod
    def broadcast(self, tensor, src_rank: int = 0): ...

    @abstractmethod
    def allgather(self, tensor) -> List[Any]: ...

    @abstractmethod
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM): ...

    @abstractmethod
    def barrier(self): ...

    @abstractmethod
    def send(self, tensor, dst_rank: int): ...

    @abstractmethod
    def recv(self, src_rank: int): ...

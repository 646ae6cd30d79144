"""Collective types: reduce ops, backend registry.

reference: python/ray/util/collective/types.py (ReduceOp, Backend).
"""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class CollectiveAbortError(RuntimeError):
    """A pending collective was aborted because a group member died or its
    node began draining (preemption).  Raised within seconds instead of
    letting ``store_wait`` hang to its full timeout; the group stays
    poisoned — every subsequent op raises immediately — until the group is
    re-initialized (reference direction: fault-aware collectives, arxiv
    2510.20171)."""


class Backend:
    """Backend name constants (reference: collective.py:81-96 dispatch).

    - ``NCCL``: a ``torch.distributed`` process group per named group (a
      TCPStore rendezvous published through the store actor); CUDA tensors
      ride NCCL, CPU tensors gloo (the twin of the JAX package's ``XLA``).
    - ``STORE``: named-store-actor rendezvous + object-store data plane —
      control-plane collectives that work anywhere (the gloo analog).
    """

    NCCL = "nccl"
    STORE = "store"

    @staticmethod
    def validate(name: str) -> str:
        name = str(name).lower()
        if name in ("gloo", "torch_gloo", "mpi"):
            # the reference's host-side names map onto the store backend,
            # as in the JAX package, so its user code ports unchanged
            return Backend.STORE
        if name == "xla":
            raise ValueError(
                "collective backend 'xla' is the JAX package's; the port's "
                "device backend is 'nccl'")
        if name not in (Backend.NCCL, Backend.STORE):
            raise ValueError(f"unknown collective backend {name!r}")
        return name

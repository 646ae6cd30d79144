"""ray_tpu_torch.util.collective — collectives across actors/tasks.

reference: python/ray/util/collective/ (API collective.py:150-652). Backends:
``nccl`` (a torch.distributed process group per named group: NCCL for CUDA
tensors, gloo for CPU ones) and ``store`` (named-store-actor data plane —
the gloo analog); the int8 codec is ``compression``.  What is still to come
is model parallelism over these groups (ROADMAP A11).
"""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allreduce,
    allreduce_pytree,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    plan_explain,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.util.collective.types import (
    Backend,
    CollectiveAbortError,
    ReduceOp,
)

__all__ = [
    "CollectiveAbortError",
    "init_collective_group",
    "create_collective_group",
    "destroy_collective_group",
    "is_group_initialized",
    "get_rank",
    "get_collective_group_size",
    "allreduce",
    "allreduce_pytree",
    "plan_explain",
    "reduce",
    "broadcast",
    "allgather",
    "reducescatter",
    "barrier",
    "send",
    "recv",
    "Backend",
    "ReduceOp",
]

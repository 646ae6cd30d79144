"""Control-plane collectives for train workers.

reference: python/ray/train/collective/collectives.py —
broadcast_from_rank_zero :23, barrier :88 (gloo-style control collectives).
Backed by the STORE collective group keyed to the training run.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.train._internal.session import get_session
from ray_tpu_torch.util import collective as col


def _ensure_group() -> str:
    s = get_session()
    if s is None:
        raise RuntimeError("not inside a training session")
    group = f"_train_{s.run_name}"
    if not col.is_group_initialized(group):
        col.init_collective_group(
            s.world_size, s.world_rank, backend=col.Backend.STORE, group_name=group
        )
    return group


def broadcast_from_rank_zero(data: Any = None) -> Any:
    """Every worker returns rank 0's ``data`` (reference: collectives.py:23)."""
    import pickle

    import numpy as np

    group = _ensure_group()
    payload = pickle.dumps(data) if get_session().world_rank == 0 else b""
    arr = np.frombuffer(payload, dtype=np.uint8)
    out = col.broadcast(arr, 0, group)
    return pickle.loads(bytes(np.asarray(out)))


def barrier() -> None:
    """Block until every worker arrives (reference: collectives.py:88)."""
    col.barrier(_ensure_group())


def allreduce_gradients(grads: Any, *, bucket_bytes: int = 4 << 20,
                        compression=None, average: bool = True) -> Any:
    """Bucketed, pipelined gradient sync across the training gang — the
    DDP-style overlap on the trainer's store path: the gradient pytree
    partitions into size-targeted buckets (reverse materialization order)
    and bucket k+1's store round is issued while bucket k's result
    uploads (``collective.allreduce_pytree``).  ``compression`` composes
    per bucket (error-feedback residuals keyed per bucket).  Returns the
    summed — or, by default, world-size-averaged — gradient tree."""
    group = _ensure_group()
    out = col.allreduce_pytree(grads, group_name=group,
                               bucket_bytes=bucket_bytes,
                               compression=compression)
    if not average:
        return out
    world = float(get_session().world_size)
    if world <= 1:
        return out
    from ray_tpu_torch._private.tree import tree_map

    return tree_map(lambda a: a / world, out)

"""Gradient-bucket partitioning for compute-overlapped gradient sync (port
of the JAX package's ``parallel/bucketing.py`` over trees of torch tensors,
flattened in ``jax.tree`` order by ``_private/tree.py``).

The DDP/large-trainer standard (arxiv 2510.20171 documents it as the trick
100k-GPU training cannot ship without): instead of one fused end-of-step
gradient allreduce, partition the gradient pytree into size-targeted
buckets and launch each bucket's collective as its gradients materialize,
so communication overlaps the remaining backward compute.

The partition must be a PURE function of the gradient tree's structure and
leaf shapes — every rank derives it independently and the sequences must
match exactly (the collective-ordering contract), which is what
``test_overlap_grad_sync`` pins with tree-equality across fresh
derivations (the JAX package's test).

Ordering: REVERSE materialization order.  Backward runs last layer first,
so the bucket holding the last layer's gradients is complete earliest and
its sync launches while earlier layers are still differentiating; we
approximate materialization order with the flattened-tree leaf order
(parameter/layer order) reversed.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB — the DDP default neighborhood


def _leaf_nbytes(leaf) -> int:
    """Size of one leaf in bytes from shape/dtype metadata only (a tensor,
    a meta tensor, or a numpy array)."""
    size = 1
    for d in getattr(leaf, "shape", ()):
        size *= int(d)
    itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", 4)
    return size * int(itemsize)


def partition_buckets(tree: Any,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES
                      ) -> List[Tuple[int, ...]]:
    """Partition a pytree's leaves into size-targeted buckets.

    Returns a list of index tuples over the tree's FLATTENED leaf order
    (``tree_leaves`` order); buckets appear in launch order = reverse
    leaf order (last layer first).  Every leaf lands in exactly one
    bucket; a bucket closes once it reaches ``bucket_bytes`` (a single
    oversized leaf forms its own bucket — leaves are never split, so
    shardings and EF residual shapes stay leaf-aligned).

    ``tree`` may hold concrete tensors or meta tensors — only shape/dtype
    metadata is read, so a partition computed ahead from meta tensors
    matches the runtime one exactly.
    """
    from ray_tpu_torch._private.tree import tree_leaves

    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    leaves = tree_leaves(tree)
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for idx in reversed(range(len(leaves))):
        nb = _leaf_nbytes(leaves[idx])
        cur.append(idx)
        cur_bytes += nb
        if cur_bytes >= bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(tuple(cur))
    return buckets


def bucket_summary(tree: Any,
                   bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """Operator-facing view of a partition: bucket count, per-bucket bytes,
    and the size target — for plan_explain-style debugging and bench."""
    from ray_tpu_torch._private.tree import tree_leaves

    leaves = tree_leaves(tree)
    buckets = partition_buckets(tree, bucket_bytes)
    sizes = [sum(_leaf_nbytes(leaves[i]) for i in b) for b in buckets]
    return {
        "bucket_bytes_target": int(bucket_bytes),
        "num_buckets": len(buckets),
        "num_leaves": len(leaves),
        "bucket_nbytes": sizes,
        "total_nbytes": sum(sizes),
    }


def flatten_bucket(tensors: Sequence, indices: Tuple[int, ...]):
    """Concatenate one bucket's leaves into a single flat tensor (the wire
    payload) plus the split metadata to undo it.

    The payload dtype is torch's promotion over the bucket's leaves —
    NEVER a hard f32 cast: int64 counters must sum exactly and f64
    gradients must keep their precision through a lossless round (the
    int8 codec, when a spec asks for it, applies downstream to float
    payloads only)."""
    import torch

    parts = [tensors[i].detach().reshape(-1) for i in indices]
    splits = [p.numel() for p in parts]
    if not parts:
        return torch.zeros(0), splits
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts]), splits


def unflatten_bucket(flat, indices: Tuple[int, ...], splits, like_tensors):
    """Inverse of :func:`flatten_bucket`: scatter the reduced flat tensor
    back into per-leaf tensors shaped and typed like ``like_tensors``."""
    out = {}
    off = 0
    for i, n in zip(indices, splits):
        ref = like_tensors[i]
        out[i] = flat[off:off + n].reshape(ref.shape).to(ref.dtype)
        off += n
    return out

"""Collective API over actors/tasks (port of the JAX package's
``util/collective/collective.py``: the ``nccl`` backend is ``NCCLGroup``,
and ``allreduce_pytree`` reduces trees of torch tensors).

reference: python/ray/util/collective/collective.py — init_collective_group
:150, create_collective_group :187, allreduce :295, barrier :335, reduce
:348, broadcast :410, allgather :460, reducescatter :509, send/recv
:568,631; GroupManager :60 with backend dispatch :81-96.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.collective.types import Backend, ReduceOp

logger = logging.getLogger(__name__)


class GroupManager:
    """Process-local registry of the collective groups this process is in
    (reference: collective.py:60)."""

    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: str, world_size: int, rank: int, group_name: str):
        backend = Backend.validate(backend)
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(f"collective group {group_name!r} already exists")
        if backend == Backend.NCCL:
            from ray_tpu_torch.util.collective.collective_group.nccl_group import NCCLGroup

            g = NCCLGroup(world_size, rank, group_name)
        else:
            from ray_tpu_torch.util.collective.collective_group.store_group import StoreGroup

            g = StoreGroup(world_size, rank, group_name)
        with self._lock:
            self._groups[group_name] = g
        return g

    def get_group(self, group_name: str):
        with self._lock:
            return self._groups.get(group_name)

    def destroy_group(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy()


_group_mgr = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = Backend.STORE,
    group_name: str = "default",
    compression=None,
):
    """Join this process into a collective group; blocks until all ranks join
    (reference: collective.py:150).  ``compression`` sets the group-wide
    default ('int8', a CompressionSpec/dict, or None) — per-call
    ``compression=`` on an op overrides it; every member must pass the same
    value or ranks would disagree on the wire format."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    from ray_tpu_torch.util.collective import compression as comp

    # validate BEFORE the blocking rendezvous: a bad spec must not leave a
    # registered group behind (is_group_initialized would say True and a
    # corrected retry would hit the stale group)
    spec = comp.resolve_spec(compression)
    g = _group_mgr.create_group(backend, world_size, rank, group_name)
    g.default_compression = spec
    return g


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = Backend.STORE,
    group_name: str = "default",
    compression=None,
):
    """Driver-side declarative setup (reference: collective.py:187): registers
    group metadata and invokes init on each actor via a hidden task, so actor
    code can call collective ops without its own init call.  ``compression``
    becomes the group default on every member (one declaration point, so
    ranks can't disagree on the wire format)."""
    import ray_tpu_torch
    from ray_tpu_torch.actor import ActorMethod
    from ray_tpu_torch.util.collective import compression as comp
    from ray_tpu_torch.util.collective.store import get_or_create_store

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have equal length")
    spec = comp.resolve_spec(compression)  # validate on the driver, loudly
    store = get_or_create_store()
    ray_tpu_torch.get(store.declare_group.remote(group_name, world_size, Backend.validate(backend)))
    refs = [
        ActorMethod(a, "__ray_tpu_call__").remote(
            _init_in_actor, world_size, r, backend, group_name, spec
        )
        for a, r in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs)


def _init_in_actor(instance, world_size, rank, backend, group_name,
                   compression=None):
    init_collective_group(world_size, rank, backend=backend,
                          group_name=group_name, compression=compression)


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.get_group(group_name) is not None


def destroy_collective_group(group_name: str = "default"):
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.world_size if g else -1


def _require_group(group_name: str):
    g = _group_mgr.get_group(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this process; "
            "call init_collective_group first"
        )
    return g


# -- per-op built-in telemetry (reference direction: PAPERS.md "Collective
# Communication for 100k+ GPUs" — straggler hunting needs per-op bytes /
# latency / bandwidth).  The payload size comes from the tensor's own
# ``nbytes`` (jax/numpy/torch all expose it) — never np.asarray(), which
# would COPY device arrays to host on the hot path.


def _tensor_meta(tensor):
    nbytes = getattr(tensor, "nbytes", None)
    if nbytes is None:
        try:
            import numpy as _np

            nbytes = _np.asarray(tensor).nbytes  # small host values only
        except Exception:  # noqa: BLE001
            nbytes = 0
    return int(nbytes or 0), str(getattr(tensor, "dtype", ""))


def _record_op(op: str, group, tensor, seconds: float):
    try:
        from ray_tpu_torch._private import runtime_metrics

        nbytes, dtype = _tensor_meta(tensor) if tensor is not None else (0, "")
        backend = type(group).__name__.replace("Group", "").lower()
        runtime_metrics.record_collective(
            op, backend, group.world_size, nbytes, seconds, dtype)
    except Exception:  # noqa: BLE001 — telemetry must never fail a
        pass  # completed collective (the result is already computed)


def _trace_op(op: str, group, tensor, seconds: float, extra=None):
    """Span child of the active trace (serve request / task / user span) —
    per-op latency attribution on the causal timeline.  The guard is one
    thread-local read, so untraced ops pay ~nothing.  ``extra`` merges
    additional attributes (the compressed path's algorithm/wire figures)."""
    try:
        from ray_tpu_torch.util import tracing

        if not tracing.context_active():
            return
        nbytes, dtype = _tensor_meta(tensor) if tensor is not None else (0, "")
        end = time.time()
        attributes = {"world_size": group.world_size, "nbytes": nbytes,
                      "dtype": dtype}
        if extra:
            attributes.update(extra)
        tracing.emit_span(
            f"collective:{op}", end - seconds, end, kind="collective",
            attributes=attributes)
    except Exception:  # noqa: BLE001 — telemetry must never fail an op
        pass


def _timed(op: str, group, tensor, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    _record_op(op, group, tensor, dt)
    _trace_op(op, group, tensor, dt)
    return out


def _record_compression(op: str, group, stats):
    """Book a compression-enabled op's logical-vs-wire accounting.  Called
    only when the backend filled last_op_stats — the stock path books
    nothing here, keeping compression-off metric output byte-identical."""
    try:
        from ray_tpu_torch._private import runtime_metrics

        backend = type(group).__name__.replace("Group", "").lower()
        runtime_metrics.record_collective_compression(
            op, backend, group.world_size, group.group_name,
            stats.logical_bytes, stats.wire_bytes, stats.algorithm,
            stats.scheme, stats.quant_error, stats.inter_slice_bytes)
    except Exception:  # noqa: BLE001 — telemetry must never fail an op
        pass


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM,
              compression=None):
    """Allreduce ``tensor`` across the group.

    ``compression``: None inherits the group default; 'none' forces the
    stock path; 'int8' / a dict / a CompressionSpec enables the
    block-quantized and/or hierarchical algorithms for this call (large
    float SUM payloads only — everything else falls back untouched).
    """
    g = _require_group(group_name)
    spec = compression if compression is not None else g.default_compression
    if spec is None:
        return _timed("allreduce", g, tensor, lambda: g.allreduce(tensor, op))
    t0 = time.perf_counter()
    out = g.allreduce(tensor, op, compression=spec)
    dt = time.perf_counter() - t0
    _record_op("allreduce", g, tensor, dt)
    stats = g.last_op_stats
    if stats is not None:
        _record_compression("allreduce", g, stats)
        extra = {"algorithm": stats.algorithm, "scheme": stats.scheme,
                 "wire_bytes": stats.wire_bytes}
        if stats.quant_error >= 0.0:  # negative = unmeasured sentinel
            extra["quant_error"] = round(stats.quant_error, 6)
        _trace_op("allreduce", g, tensor, dt, extra=extra)
    else:
        _trace_op("allreduce", g, tensor, dt)
    return out


def allreduce_pytree(tree, group_name: str = "default",
                     op: ReduceOp = ReduceOp.SUM,
                     bucket_bytes: int = 4 << 20, compression=None):
    """Bucketed, pipelined allreduce of a whole gradient tree of torch
    tensors (nested dicts, tuples and lists, flattened in ``jax.tree``
    order).

    The tree partitions into size-targeted buckets (reverse
    materialization order — parallel/bucketing.py; deterministic, so all
    ranks issue identical sequences), each flattened to one tensor on its
    leaves' device.  On the store backend the buckets ride
    ``StoreGroup.allreduce_bucketed`` (contributions fired without
    waiting); the nccl backend reduces bucket by bucket (NCCL for CUDA
    leaves).  ``compression`` composes per bucket (error-feedback
    residuals keyed per bucket).  Returns the reduced tree.
    """
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.parallel.bucketing import (
        flatten_bucket,
        partition_buckets,
        unflatten_bucket,
    )

    g = _require_group(group_name)
    spec = compression if compression is not None else g.default_compression
    leaves = tree_leaves(tree)
    buckets = partition_buckets(tree, bucket_bytes)
    payloads, metas = [], []
    for b in buckets:
        flat, splits = flatten_bucket(leaves, b)
        payloads.append(flat)
        metas.append((b, splits))
    t0 = time.perf_counter()
    if hasattr(g, "allreduce_bucketed"):
        reduced = g.allreduce_bucketed(payloads, op, compression=spec)
    else:
        reduced = [g.allreduce(p, op, compression=spec) for p in payloads]
    dt = time.perf_counter() - t0
    out = list(leaves)
    for flat, (b, splits) in zip(reduced, metas):
        for i, leaf in unflatten_bucket(flat, b, splits, leaves).items():
            out[i] = leaf
    total = int(sum(t.numel() * t.element_size() for t in leaves))
    _record_op("allreduce", g, None, dt)
    stats = getattr(g, "last_op_stats", None)
    if stats is not None:
        _record_compression("allreduce", g, stats)
        _trace_op("allreduce", g, None, dt,
                  extra={"algorithm": stats.algorithm,
                         "scheme": stats.scheme,
                         "wire_bytes": stats.wire_bytes,
                         "nbytes": total, "buckets": len(buckets)})
    else:
        _trace_op("allreduce", g, None, dt,
                  extra={"nbytes": total, "buckets": len(buckets)})
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def plan_explain(nbytes: int, group_name: str = "default",
                 compression=None) -> dict:
    """Why would the planner pick what it picks for an ``nbytes`` payload
    on this group's real topology?  Returns the candidate cost table, the
    chosen algorithm, and the reason (see planner.plan_explain)."""
    g = _require_group(group_name)
    if hasattr(g, "plan_explain"):
        return g.plan_explain(nbytes, compression=compression)
    from ray_tpu_torch.util.collective import compression as comp
    from ray_tpu_torch.util.collective import planner as _planner

    spec = comp.resolve_spec(compression) or g.default_compression
    return _planner.plan_explain(
        nbytes, _planner.Topology.flat(g.world_size), spec)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    g = _require_group(group_name)
    return _timed("reduce", g, tensor, lambda: g.reduce(tensor, dst_rank, op))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _require_group(group_name)
    return _timed("broadcast", g, tensor, lambda: g.broadcast(tensor, src_rank))


def allgather(tensor, group_name: str = "default"):
    g = _require_group(group_name)
    return _timed("allgather", g, tensor, lambda: g.allgather(tensor))


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _require_group(group_name)
    return _timed("reducescatter", g, tensor, lambda: g.reducescatter(tensor, op))


def barrier(group_name: str = "default"):
    g = _require_group(group_name)
    _timed("barrier", g, None, g.barrier)


def send(tensor, dst_rank: int, group_name: str = "default"):
    g = _require_group(group_name)
    _timed("send", g, tensor, lambda: g.send(tensor, dst_rank))


def recv(src_rank: int, group_name: str = "default"):
    g = _require_group(group_name)
    t0 = time.perf_counter()
    out = g.recv(src_rank)
    dt = time.perf_counter() - t0
    _record_op("recv", g, out, dt)
    _trace_op("recv", g, out, dt)
    return out

"""STORE backend: collectives via the named store actor + object store.

The gloo analog (reference: gloo_collective_group.py:185): works between any
ray_tpu_torch actors/tasks with no accelerator coupling — used for control-plane
collectives (ray.train.collective-style broadcast/barrier) and for tests.
Every op is a contribute/collect round on the store actor keyed by a
per-group monotonically increasing sequence number, so all ranks must issue
collectives in the same order (the standard collective contract).
"""

from __future__ import annotations

import time
from typing import Any, List

import numpy as np
import torch

from ray_tpu_torch.util.collective import compression as comp
from ray_tpu_torch.util.collective import planner as topo_planner
from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.store import (
    check_abort,
    get_or_create_store,
    store_wait,
)
from ray_tpu_torch.util.collective.types import CollectiveAbortError, ReduceOp

_REDUCERS = {
    ReduceOp.SUM: lambda xs: _tree_reduce(np.add, xs),
    ReduceOp.PRODUCT: lambda xs: _tree_reduce(np.multiply, xs),
    ReduceOp.MIN: lambda xs: _tree_reduce(np.minimum, xs),
    ReduceOp.MAX: lambda xs: _tree_reduce(np.maximum, xs),
}


def _tree_reduce(op, xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x)
    return acc


def _to_numpy(tensor):
    """numpy view of a tensor + a converter back to the original kind: a
    torch tensor goes to the host, a bf16 one as fp32 (exactly: numpy has
    no bf16)."""
    if isinstance(tensor, np.ndarray):
        return tensor, lambda a: a
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), None  # converter built lazily below
    return np.asarray(tensor), lambda a: a


def _convert_back(result_np, original):
    """A result for ``original``: a torch tensor's in its dtype and on its
    device (a bf16 one rounded once from the fp32 sum)."""
    if isinstance(original, np.ndarray):
        return result_np
    if isinstance(original, torch.Tensor):
        out = torch.from_numpy(np.require(result_np, requirements=["C", "W"]))
        return out.to(device=original.device, dtype=original.dtype)
    if isinstance(original, (int, float)):
        return type(original)(result_np)
    return result_np


def _kind(tensor):
    """(dtype name, device type) of a torch tensor, else None: what a
    receiver needs to give the tensor back."""
    if isinstance(tensor, torch.Tensor):
        return str(tensor.dtype).split(".")[1], tensor.device.type
    return None


def _from_wire(value):
    """Inverse of a send's ``{"array", "kind"}`` (a dict: a tuple could
    pass for the abort sentinel): the tensor as it was sent (on the card
    when it was sent from one and this process has one)."""
    arr, kind = value["array"], value["kind"]
    if kind is None:
        return arr
    dtype, device = kind
    out = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        getattr(torch, dtype))
    if device == "cuda" and torch.cuda.is_available():
        out = out.cuda()
    return out


class StoreGroup(BaseGroup):
    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        self._store = get_or_create_store()
        self._seq = 0
        self._p2p_send_seq = {}
        self._p2p_recv_seq = {}
        # set to the abort reason once the group is poisoned; every
        # subsequent op raises immediately until the group is re-initialized
        self._aborted: str | None = None
        # register identity for the store's liveness monitor: a member
        # dying (or its node draining) aborts the whole group promptly
        self._join_membership()
        # join barrier so ops can't start before all ranks exist
        self._sync("join")
        # explicit topology for the planner, built AFTER the join barrier
        # (all members' node identities are registered by then) and cached
        # for the group's lifetime — membership change means re-init,
        # which builds a fresh group and re-derives/re-probes
        self._topology = self._build_topology()

    def _build_topology(self) -> topo_planner.Topology:
        """Topology from group-member node identity: ranks sharing a node
        form one latency domain (the "slice" of the store backend's
        hierarchical algorithm); the store round-trip probe calibrates
        the link β term.  Unknown node ids (driver-less tests) collapse
        to a single domain."""
        import ray_tpu_torch

        ids = [None] * self._world_size
        try:
            members = ray_tpu_torch.get(
                self._store.get_members.remote(self._group_name))
            for rank, m in (members or {}).items():
                if 0 <= rank < self._world_size:
                    ids[rank] = (m or {}).get("node_id")
        except Exception:  # noqa: BLE001 — topology is advisory
            pass
        slice_ids = tuple(i if i is not None else "?unknown" for i in ids)
        if all(i == "?unknown" for i in slice_ids):
            slice_ids = tuple([0] * self._world_size)
        kw = {}
        bw = self._probe_link_bandwidth()
        if bw is not None:
            kw["intra_bw"] = bw
            kw["inter_bw"] = bw
        return topo_planner.Topology.from_slice_ids(
            slice_ids, intra_link=topo_planner.LINK_HOST,
            inter_link=topo_planner.LINK_DCN, **kw)

    def _probe_link_bandwidth(self):
        """One-shot store-link probe (~1 ms): round-trip a 64 KiB payload
        through the store actor and derive bytes/s — every byte a store
        collective moves crosses this link, so it is the β term for every
        algorithm on this backend.  Failures fall back to defaults."""
        if self._world_size <= 1:
            return None
        try:
            import ray_tpu_torch

            payload = np.ones(16384, np.float32)  # 64 KiB
            key = (self._group_name, "_bwprobe", self._rank)
            t0 = time.perf_counter()
            ray_tpu_torch.get(self._store.put.remote(key, payload))
            ray_tpu_torch.get(self._store.pop.remote(key))
            dt = time.perf_counter() - t0
            if dt <= 0:
                return None
            return 2 * payload.nbytes / dt
        except Exception:  # noqa: BLE001 — probe is advisory, never fatal
            return None

    def topology(self) -> topo_planner.Topology:
        return self._topology

    # algorithms this backend implements (no tree: pairwise exchange
    # rounds through a central store pay w·α per round, never winning)
    _PLANNABLE = (comp.ALG_FLAT, comp.ALG_RING, comp.ALG_HIERARCHICAL)

    def plan_explain(self, nbytes: int, compression=None) -> dict:
        """Debug surface: the planner's candidate table for a payload of
        ``nbytes`` on this group's real topology."""
        spec = comp.resolve_spec(compression)
        if spec is None:
            spec = self.default_compression
        return topo_planner.plan_explain(nbytes, self._topology, spec,
                                         allowed=self._PLANNABLE)

    def _join_membership(self):
        import ray_tpu_torch

        member = {"actor_id": None, "node_id": None}
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            w = get_global_worker()
            if w.actor_id is not None:
                member["actor_id"] = w.actor_id.hex()
            if w.node_id is not None:
                member["node_id"] = w.node_id.hex()
        except Exception:  # noqa: BLE001 — driver-less test contexts
            pass
        ray_tpu_torch.get(self._store.join_member.remote(
            self._group_name, self._rank, member))

    def _abort(self, reason: str):
        """Poison this group locally, book the abort metric, and raise."""
        if self._aborted is None:
            self._aborted = reason
            try:
                from ray_tpu_torch._private import runtime_metrics

                runtime_metrics.inc_collective_abort("store", self._group_name)
            except Exception:  # noqa: BLE001 — abort metric is telemetry; the raise below is the point
                pass
        raise CollectiveAbortError(
            f"collective group {self._group_name!r} aborted: {reason}; "
            "re-init the group to continue")

    def _check_live(self):
        if self._aborted is not None:
            raise CollectiveAbortError(
                f"collective group {self._group_name!r} is poisoned "
                f"({self._aborted}); re-init the group to continue")

    def _guard(self, fn):
        """Run one store round; turn an abort sentinel/error into the
        poisoned state."""
        self._check_live()
        try:
            return fn()
        except CollectiveAbortError as e:
            self._abort(str(e))

    def _next_key(self, kind: str):
        self._seq += 1
        return (self._group_name, kind, self._seq)

    def _sync(self, kind: str):
        import ray_tpu_torch

        def run():
            key = self._next_key(kind)
            self._mark(kind, "enter", seq=key[2])
            check_abort(ray_tpu_torch.get(self._store.barrier_arrive.remote(
                key, self._rank, self._world_size)))
            store_wait(self._store, "barrier_done",
                       (key, self._rank, self._world_size))
            self._mark(kind, "exit", seq=key[2])

        self._guard(run)

    def _exchange(self, kind: str, value) -> dict:
        """All-to-all gather round: contribute own value, collect everyone's."""
        import ray_tpu_torch

        def run():
            key = self._next_key(kind)
            self._mark(kind, "enter", seq=key[2])
            check_abort(ray_tpu_torch.get(
                self._store.contribute.remote(key, self._rank, value)))
            out = store_wait(self._store, "collect",
                             (key, self._world_size, self._rank))
            self._mark(kind, "exit", seq=key[2])
            return out

        return self._guard(run)

    def _exchange_sub(self, kind: str, subrank: int, count: int, value,
                      member_ranks=None) -> dict:
        """Gather round inside a subgroup (hierarchical phases): the kind
        string embeds the subgroup id, so concurrent subgroups never share a
        key; every rank runs every phase exactly once, keeping the per-group
        sequence counter aligned across all ranks.  ``member_ranks`` names
        the subgroup's GROUP-GLOBAL ranks so the store's arrival monitor
        (hang diagnosis, straggler EWMAs) never sees subranks."""
        import ray_tpu_torch

        def run():
            key = self._next_key(kind)
            self._mark(kind, "enter", seq=key[2])
            check_abort(ray_tpu_torch.get(
                self._store.contribute.remote(key, subrank, value,
                                              self._rank, member_ranks)))
            out = store_wait(self._store, "collect", (key, count, subrank))
            self._mark(kind, "exit", seq=key[2])
            return out

        return self._guard(run)

    # -- collectives --------------------------------------------------------
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM, compression=None):
        self.last_op_stats = None
        arr, _ = _to_numpy(tensor)
        plan = self._plan(arr, op, compression)
        if plan.is_stock:
            by_rank = self._exchange("allreduce", arr)
            out = _REDUCERS[op]([by_rank[r] for r in range(self._world_size)])
            return _convert_back(out, tensor)
        if plan.algorithm == comp.ALG_HIERARCHICAL:
            out, stats = self._hierarchical_allreduce(arr, op, plan)
        elif plan.algorithm == comp.ALG_RING:
            out, stats = self._ring_allreduce(arr, op, plan)
        elif plan.scheme == comp.SCHEME_INT8:
            out, stats = self._quantized_allreduce(arr, plan)
        else:
            # a lossless algorithm this backend doesn't implement must
            # NEVER fall into the quantized path — run the stock exchange
            by_rank = self._exchange("allreduce", arr)
            out = _REDUCERS[op]([by_rank[r] for r in range(self._world_size)])
            return _convert_back(out, tensor)
        self.last_op_stats = stats
        return _convert_back(out.astype(arr.dtype, copy=False), tensor)

    def _plan(self, arr: np.ndarray, op: ReduceOp, compression) -> comp.Plan:
        spec = comp.resolve_spec(compression)
        plan = topo_planner.plan_allreduce(arr.nbytes, self._topology, spec,
                                           allowed=self._PLANNABLE)
        if spec is not None:
            topo_planner.record_plan(plan.algorithm, plan.reason)
        if plan.scheme != comp.SCHEME_NONE and (
                op != ReduceOp.SUM or not comp.is_float_dtype(arr.dtype)):
            # quantization is only meaningful for float SUM-reductions;
            # keep the (lossless) algorithm choice, drop the codec
            import dataclasses as _dc

            plan = _dc.replace(plan, scheme=comp.SCHEME_NONE)
        return plan

    def _ring_allreduce(self, arr: np.ndarray, op: ReduceOp,
                        plan: comp.Plan):
        """Chunked ring (reduce-scatter + allgather through the store):
        the payload splits into ``world`` chunks; every rank contributes
        ALL chunks up front (uploads pipeline instead of serializing in
        one giant round trip), but each chunk's reduction is owned by one
        rank, which alone downloads that chunk's ``world`` contributions
        — per-rank download drops from (n-1)·S (flat exchange) to ~2·S.
        The reduced chunks then allgather in one ordinary round."""
        import ray_tpu_torch

        w = self._world_size

        def run():
            flat = comp.pad_to_multiple(arr.ravel(), w)
            cs = flat.size // w
            # every rank derives the SAME key sequence (loop order is part
            # of the collective contract, like any op ordering)
            rs_keys = [self._next_key(f"ring_rs_c{j}") for j in range(w)]
            ag_key = self._next_key("ring_ag")
            self._mark("ring_allreduce", "enter", seq=ag_key[2])
            # phase 1a — contribute all chunks WITHOUT waiting: uploads
            # overlap each other and the collect below
            refs = [self._store.contribute.remote(
                rs_keys[j], self._rank, flat[j * cs:(j + 1) * cs])
                for j in range(w)]
            # phase 1b — reduce the one chunk this rank owns (single
            # reader: the store GCs the entry on our read)
            for v in ray_tpu_torch.get(refs):
                check_abort(v)
            by_rank = store_wait(
                self._store, "collect", (rs_keys[self._rank], w, self._rank, 1))
            mine = _REDUCERS[op]([by_rank[r] for r in range(w)])
            # phase 2 — allgather the reduced chunks
            check_abort(ray_tpu_torch.get(self._store.contribute.remote(
                ag_key, self._rank, mine)))
            by_owner = store_wait(self._store, "collect",
                                  (ag_key, w, self._rank))
            out = np.concatenate(
                [by_owner[r] for r in range(w)])[:arr.size]
            self._mark("ring_allreduce", "exit", seq=ag_key[2])
            wire, _ = comp.estimate_wire_bytes(
                comp.ALG_RING, comp.SCHEME_NONE, int(flat.nbytes), w)
            stats = comp.OpStats(
                logical_bytes=int(arr.nbytes), wire_bytes=wire,
                algorithm=comp.ALG_RING, scheme=comp.SCHEME_NONE)
            return out.reshape(arr.shape), stats

        return self._guard(run)

    def _quantized_allreduce(self, arr: np.ndarray, plan: comp.Plan):
        """Flat quantized: every rank contributes int8 codes + per-block
        scales instead of the raw float payload; each rank dequantizes all
        contributions and sums — all ranks see bit-identical results."""
        spec = plan.spec
        n = arr.size
        codes, scales, _deq, qerr = comp.ef_quantize(
            self._group_name, "allreduce", arr, spec)
        by_rank = self._exchange("allreduce_q", (codes, scales))
        acc = np.zeros(n, np.float32)
        for r in range(self._world_size):
            c_r, s_r = by_rank[r]
            acc += comp.dequantize_blocks(c_r, s_r, n, spec.block_size)
        stats = comp.OpStats(
            logical_bytes=int(arr.nbytes),
            wire_bytes=comp.wire_nbytes(codes, scales),
            algorithm=comp.ALG_FLAT, scheme=plan.scheme, quant_error=qerr)
        return acc.reshape(arr.shape), stats

    def _hierarchical_allreduce(self, arr: np.ndarray, op: ReduceOp,
                                plan: comp.Plan):
        """Two-level algorithm (TACCL-shaped): intra-slice reduce-scatter,
        inter-slice exchange on 1/slice shards (optionally quantized — this
        is the DCN phase the algorithm exists to shrink), intra-slice
        allgather.  Slices are contiguous rank blocks of ``slice_size``."""
        spec = plan.spec
        ss = plan.slice_size
        nslices = self._world_size // ss
        sid, idx = self._rank // ss, self._rank % ss
        # global-rank membership of each subgroup this rank exchanges in —
        # the arrival monitor is keyed by global rank, never subrank
        slice_ranks = [sid * ss + j for j in range(ss)]
        cross_ranks = [s * ss + idx for s in range(nslices)]
        flat = comp.pad_to_multiple(arr.ravel(), ss)
        shard_n = flat.size // ss
        lo, hi = idx * shard_n, (idx + 1) * shard_n

        # phase 1 — intra-slice reduce-scatter: exchange full payloads
        # inside the slice, each member reduces its own shard
        by_idx = self._exchange_sub(f"hier_rs_s{sid}", idx, ss, flat,
                                    member_ranks=slice_ranks)
        my_shard = _REDUCERS[op]([by_idx[j][lo:hi] for j in range(ss)])
        wire_intra = int(flat.nbytes)

        # phase 2 — inter-slice allreduce of the shard among same-index
        # members across slices (1/slice of the payload crosses DCN)
        quantized = plan.scheme == comp.SCHEME_INT8
        if quantized:
            codes, scales, _deq, qerr = comp.ef_quantize(
                self._group_name, "allreduce_hier", my_shard, spec)
            by_slice = self._exchange_sub(
                f"hier_x_i{idx}", sid, nslices, (codes, scales),
                member_ranks=cross_ranks)
            acc = np.zeros(shard_n, np.float32)
            for s in range(nslices):
                c_s, s_s = by_slice[s]
                acc += comp.dequantize_blocks(c_s, s_s, shard_n,
                                              spec.block_size)
            global_shard = acc.astype(flat.dtype, copy=False)
            wire_inter = comp.wire_nbytes(codes, scales)
        else:
            qerr = 0.0
            by_slice = self._exchange_sub(
                f"hier_x_i{idx}", sid, nslices, my_shard,
                member_ranks=cross_ranks)
            global_shard = _REDUCERS[op](
                [by_slice[s] for s in range(nslices)])
            wire_inter = int(my_shard.nbytes)

        # phase 3 — intra-slice allgather of the globally-reduced shards
        by_idx3 = self._exchange_sub(f"hier_ag_s{sid}", idx, ss, global_shard,
                                     member_ranks=slice_ranks)
        out = np.concatenate([by_idx3[j] for j in range(ss)])[:arr.size]
        wire_intra += int(global_shard.nbytes)

        stats = comp.OpStats(
            logical_bytes=int(arr.nbytes),
            wire_bytes=wire_intra + wire_inter,
            algorithm=comp.ALG_HIERARCHICAL, scheme=plan.scheme,
            quant_error=qerr, inter_slice_bytes=wire_inter)
        return out.reshape(arr.shape), stats

    def allreduce_bucketed(self, arrays: List[np.ndarray],
                           op: ReduceOp = ReduceOp.SUM, compression=None):
        """Pipelined bucketed allreduce (the DDP overlap trick on the
        store transport): ``arrays`` is the deterministic bucket sequence
        (identical on every rank — the bucket partition is a pure function
        of the gradient tree); bucket k+1's contribution is ISSUED while
        bucket k's round is still uploading/collecting, so store round
        trips overlap instead of serializing end-to-end.

        Per-bucket compression composes with the codec: the
        error-feedback residual keys embed the bucket index (op string
        ``allreduce_b<k>``), so each bucket carries its own residual.
        Returns the reduced arrays in bucket order; ``last_op_stats``
        aggregates the whole sequence.
        """
        import ray_tpu_torch

        self.last_op_stats = None
        w = self._world_size
        spec = comp.resolve_spec(compression)
        if spec is None:
            spec = self.default_compression

        def run():
            staged = []  # (key, ref, quantized, qmeta...)
            logical = wire = 0
            qerr = 0.0
            for k, arr in enumerate(arrays):
                a = np.ascontiguousarray(_to_numpy(arr)[0])
                quantize = (spec is not None
                            and spec.scheme == comp.SCHEME_INT8
                            and op == ReduceOp.SUM
                            and comp.is_float_dtype(a.dtype)
                            and a.nbytes >= spec.min_bytes and w > 1)
                if spec is not None:
                    topo_planner.record_plan(
                        comp.ALG_FLAT,
                        "bucketed_pipeline" if w > 1 else "solo")
                if quantize:
                    codes, scales, _deq, e = comp.ef_quantize(
                        self._group_name, f"allreduce_b{k}", a, spec)
                    payload = (codes, scales)
                    wire += comp.wire_nbytes(codes, scales)
                    qerr = max(qerr, e)
                else:
                    payload = a
                    wire += int(a.nbytes)
                logical += int(a.nbytes)
                key = self._next_key(f"bucket_ar_b{k}")
                self._mark("bucket_allreduce", "enter", seq=key[2])
                # fire-and-continue: the next bucket's upload overlaps
                # this round's completion
                ref = self._store.contribute.remote(key, self._rank, payload)
                staged.append((key, ref, quantize, a))
            outs = []
            for key, ref, quantize, a in staged:
                check_abort(ray_tpu_torch.get(ref))
                by_rank = store_wait(self._store, "collect",
                                     (key, w, self._rank))
                if quantize:
                    acc = np.zeros(a.size, np.float32)
                    for r in range(w):
                        c_r, s_r = by_rank[r]
                        acc += comp.dequantize_blocks(
                            c_r, s_r, a.size, spec.block_size)
                    out = acc.reshape(a.shape).astype(a.dtype, copy=False)
                else:
                    out = _REDUCERS[op]([by_rank[r] for r in range(w)])
                self._mark("bucket_allreduce", "exit", seq=key[2])
                outs.append(_convert_back(out, arrays[len(outs)]))
            if spec is not None:
                self.last_op_stats = comp.OpStats(
                    logical_bytes=logical, wire_bytes=wire,
                    algorithm=comp.ALG_FLAT,
                    scheme=(comp.SCHEME_INT8 if any(s[2] for s in staged)
                            else comp.SCHEME_NONE),
                    quant_error=qerr)
            return outs

        return self._guard(run)

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        arr, _ = _to_numpy(tensor)
        by_rank = self._exchange("reduce", arr)
        if self._rank != dst_rank:
            return tensor
        out = _REDUCERS[op]([by_rank[r] for r in range(self._world_size)])
        return _convert_back(out, tensor)

    def broadcast(self, tensor, src_rank: int = 0):
        arr, _ = _to_numpy(tensor) if tensor is not None else (None, None)
        by_rank = self._exchange("broadcast", arr if self._rank == src_rank else None)
        return _convert_back(by_rank[src_rank], tensor) if tensor is not None \
            else by_rank[src_rank]

    def allgather(self, tensor) -> List[Any]:
        arr, _ = _to_numpy(tensor)
        by_rank = self._exchange("allgather", arr)
        return [_convert_back(by_rank[r], tensor) for r in range(self._world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        arr, _ = _to_numpy(tensor)
        if arr.shape[0] % self._world_size:
            raise ValueError(
                f"reducescatter dim0 {arr.shape[0]} not divisible by world size "
                f"{self._world_size}"
            )
        by_rank = self._exchange("reducescatter", arr)
        out = _REDUCERS[op]([by_rank[r] for r in range(self._world_size)])
        shard = out.shape[0] // self._world_size
        return _convert_back(out[self._rank * shard:(self._rank + 1) * shard], tensor)

    def barrier(self):
        self._sync("barrier")

    # -- p2p ----------------------------------------------------------------
    def send(self, tensor, dst_rank: int):
        import ray_tpu_torch

        arr, _ = _to_numpy(tensor)

        def run():
            seq = self._p2p_send_seq.get(dst_rank, 0) + 1
            self._p2p_send_seq[dst_rank] = seq
            key = (self._group_name, "p2p", self._rank, dst_rank, seq)
            check_abort(ray_tpu_torch.get(self._store.put.remote(
                key, {"array": arr, "kind": _kind(tensor)})))

        self._guard(run)

    def recv(self, src_rank: int):
        def run():
            seq = self._p2p_recv_seq.get(src_rank, 0) + 1
            self._p2p_recv_seq[src_rank] = seq
            key = (self._group_name, "p2p", src_rank, self._rank, seq)
            return _from_wire(store_wait(self._store, "pop", (key,)))

        return self._guard(run)

    def destroy(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._store.leave_group.remote(
                self._group_name, self._rank))
        except Exception:  # noqa: BLE001 — store may already be gone
            pass
        super().destroy()

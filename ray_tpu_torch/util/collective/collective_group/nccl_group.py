"""NCCL backend: one ``torch.distributed`` process group per named group.

The twin of the JAX package's ``XLAGroup``
(``ray_tpu/util/collective/collective_group/xla_group.py``; reference:
nccl_collective_group.py — NCCL comms with a rendezvous through a named
store actor :30-82).  Where ``XLAGroup`` published the jax.distributed
coordinator through the store actor, rank 0 here starts a ``TCPStore`` and
publishes its address there; every group builds its process groups on a
``PrefixStore(group_name, ...)`` over that store, never the process's
global default, so one process sits in many named groups at once (a tensor
channel makes a two-member group per edge).  Destroying a group shuts its
process groups and its ``TCPStore`` down.

One class for both devices: CUDA tensors ride a ``ProcessGroupNCCL``
(made at the first CUDA tensor), CPU tensors a ``ProcessGroupGloo`` — the
same code runs gloo on the CPU, where the tests drive it at world sizes 2
and 4, and NCCL on the card.  NCCL refuses two ranks on one device, so a
one-card machine runs NCCL at world size 1 only: the multi-GPU NCCL path is
unverified.

The planner's (copied) schedules are sequences of point-to-point and
collective calls on the group, each with a fixed order of summation, so a
repeat is bit-identical: the explicit ring (reduce-scatter + allgather
between neighbours), recursive halving-doubling ("tree", power-of-two
worlds), the EQuARX two-phase quantized allreduce (int8 codes + per-block
scales through all_to_all, a sum in rank order rounded once to the spec's
``accum_dtype``, requantized, allgathered) and the hierarchical one
(intra-slice ring reduce-scatter, the shard reduced across slices,
optionally int8, intra-slice ring allgather).  A pair exchanges in rank
order (the lower rank sends first), so blocking NCCL sends cannot wait on
each other.

A failed operation (a member died, its connection broke, a timeout)
poisons the group: it raises ``CollectiveAbortError``, and so does every
later operation until the group is re-initialized.
"""

from __future__ import annotations

import datetime
from typing import Any, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.util.collective import compression as comp
from ray_tpu_torch.util.collective import planner as topo_planner
from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.store import get_or_create_store, store_wait
from ray_tpu_torch.util.collective.types import CollectiveAbortError, ReduceOp

_TIMEOUT_S = 300.0  # a collective's and the rendezvous's wait

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}

# dtypes a point-to-point header names, by code
_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
           torch.bool]
_MAX_DIMS = 8


def _host_ip() -> str:
    """The address this process's runtime serves on (no outside host is
    asked); loopback outside a runtime."""
    try:
        from ray_tpu_torch._private.worker import get_global_worker

        return get_global_worker().address[0]
    except Exception:  # noqa: BLE001 — no runtime in this process
        return "127.0.0.1"


def _wait(work):
    work.wait()


class NCCLGroup(BaseGroup):
    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        self._timeout = datetime.timedelta(seconds=_TIMEOUT_S)
        self._aborted: str | None = None
        self._tcp = self._rendezvous()
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore(f"{group_name}/gloo", self._tcp), rank,
            world_size, self._timeout)
        self._nccl = None
        self._subgroups: dict = {}
        self._residuals: dict = {}
        # which process group ran the last operation ("gloo" or "nccl")
        self.last_backend = None
        self._topology = self._join()

    def _join(self) -> topo_planner.Topology:
        """The join barrier, and the topology for the planner: ranks sharing
        a node form one latency domain; the intra link is NVLink between
        cards (CUDA IPC on one card), host loopback in a CPU process."""
        intra = (topo_planner.LINK_NVLINK if torch.cuda.is_available()
                 else topo_planner.LINK_HOST)
        if self._world_size == 1:
            self._run("join", lambda: _wait(self._gloo.barrier()))
            return topo_planner.Topology.flat(1, link=intra)
        import ray_tpu_torch

        store = get_or_create_store()
        ray_tpu_torch.get(store.join_member.remote(
            self._group_name, self._rank, {"node_id": _node_id()}))
        self._run("join", lambda: _wait(self._gloo.barrier()))
        members = ray_tpu_torch.get(store.get_members.remote(
            self._group_name)) or {}
        if self._rank == 0:
            # every member has joined the TCPStore: a later incarnation of
            # this name must not find the address
            ray_tpu_torch.get(store.pop.remote(
                (self._group_name, "nccl_store")))
        ids = [(members.get(r) or {}).get("node_id")
               for r in range(self._world_size)]
        if any(i is None for i in ids):
            ids = [0] * self._world_size
        return topo_planner.Topology.from_slice_ids(
            tuple(ids), intra_link=intra, inter_link=topo_planner.LINK_DCN)

    # -- setup --------------------------------------------------------------
    def _rendezvous(self):
        """Rank 0 starts the group's TCPStore on a free port and publishes
        its address through the store actor; the others read it there."""
        if self._world_size == 1:
            return dist.HashStore()
        import ray_tpu_torch

        store = get_or_create_store()
        key = (self._group_name, "nccl_store")
        if self._rank == 0:
            host = _host_ip()
            tcp = dist.TCPStore(host, 0, self._world_size, True,
                                timeout=self._timeout,
                                wait_for_workers=False)
            ray_tpu_torch.get(store.put.remote(key, (host, tcp.port)))
            return tcp
        host, port = store_wait(store, "get", (key,), timeout=_TIMEOUT_S)
        return dist.TCPStore(host, port, self._world_size, False,
                             timeout=self._timeout)

    def _pg(self, tensor: torch.Tensor):
        """The process group for ``tensor``'s device: NCCL for a CUDA
        tensor (made at the first one; a constructor that does not
        communicate, so members make it as they reach it), gloo else."""
        if not tensor.is_cuda:
            return self._gloo
        if self._nccl is None:
            self._nccl = dist.ProcessGroupNCCL(
                dist.PrefixStore(f"{self._group_name}/nccl", self._tcp),
                self._rank, self._world_size)
        return self._nccl

    def _subgroup(self, kind: str, ranks: List[int]):
        """A process group over ``ranks`` (group ranks) for the hierarchical
        schedule, of the same device kind as ``kind``, made once."""
        key = (kind, tuple(ranks))
        pg = self._subgroups.get(key)
        if pg is None:
            store = dist.PrefixStore(
                f"{self._group_name}/sub/{kind}/{'-'.join(map(str, ranks))}",
                self._tcp)
            sub = ranks.index(self._rank)
            if kind == "cuda":
                pg = dist.ProcessGroupNCCL(store, sub, len(ranks))
            else:
                pg = dist.ProcessGroupGloo(store, sub, len(ranks),
                                           self._timeout)
            self._subgroups[key] = pg
        return pg

    def _check_live(self):
        if self._aborted is not None:
            raise CollectiveAbortError(
                f"collective group {self._group_name!r} is poisoned "
                f"({self._aborted}); re-init the group to continue")

    def _run(self, op: str, fn):
        """One operation: flight-recorder marks around it; a failure of the
        wire poisons the group."""
        self._check_live()
        seq = self._mark(op, "enter")
        try:
            return fn()
        except RuntimeError as e:  # DistError, gloo's closed connections
            if self._aborted is None:
                self._aborted = f"{op}: {e}"
                try:
                    from ray_tpu_torch._private import runtime_metrics

                    runtime_metrics.inc_collective_abort("nccl",
                                                         self._group_name)
                except Exception:  # noqa: BLE001 — the raise below is the point
                    pass
            raise CollectiveAbortError(
                f"collective group {self._group_name!r} aborted in {op}: "
                f"{e}; re-init the group to continue") from e
        finally:
            self._mark(op, "exit", seq=seq)

    def topology(self) -> topo_planner.Topology:
        return self._topology

    def _topology_num_slices(self) -> int:
        return self.topology().num_slices

    # algorithms this backend implements (the planner picks among these)
    _PLANNABLE = (comp.ALG_FLAT, comp.ALG_RING, comp.ALG_TREE,
                  comp.ALG_HIERARCHICAL)

    def plan_explain(self, nbytes: int, compression=None) -> dict:
        """Debug surface: the planner's candidate table for a payload of
        ``nbytes`` on this group's real topology."""
        spec = comp.resolve_spec(compression)
        if spec is None:
            spec = self.default_compression
        return topo_planner.plan_explain(nbytes, self.topology(), spec,
                                         allowed=self._PLANNABLE)

    # -- collectives --------------------------------------------------------
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM,
                  compression=None):
        """A new tensor: ``tensor`` summed (or op-reduced) over the group.
        With a compression spec in force, a float SUM takes the planner's
        schedule."""
        self.last_op_stats = None
        tensor = torch.as_tensor(tensor)
        spec = comp.resolve_spec(compression)
        if (spec is not None and op == ReduceOp.SUM
                and tensor.is_floating_point()):
            nbytes = tensor.numel() * tensor.element_size()
            plan = topo_planner.plan_allreduce(
                nbytes, self.topology(), spec, allowed=self._PLANNABLE)
            topo_planner.record_plan(plan.algorithm, plan.reason)
            if not plan.is_stock:
                return self._run(f"allreduce_{plan.algorithm}",
                                 lambda: self._planned(tensor, plan))
        out = tensor.detach().clone().contiguous()

        def run():
            pg = self._pg(out)
            opts = dist.AllreduceOptions()
            opts.reduceOp = _TORCH_OPS[op]
            _wait(pg.allreduce([out], opts))
            self.last_backend = pg.name()
            return out

        return self._run("allreduce", run)

    def _planned(self, tensor: torch.Tensor, plan: comp.Plan):
        if plan.algorithm == comp.ALG_HIERARCHICAL:
            out, stats = self._hierarchical_allreduce(tensor, plan)
        elif plan.algorithm in (comp.ALG_RING, comp.ALG_TREE):
            out, stats = self._decomposed_allreduce(tensor, plan)
        else:
            out, stats = self._quantized_allreduce(tensor, plan)
        self.last_op_stats = stats
        return out

    # point to point inside a process group: the lower rank goes first
    def _exchange(self, pg, me: int, peer: int, send: torch.Tensor,
                  recv: torch.Tensor):
        if me < peer:
            _wait(pg.send([send], peer, 0))
            _wait(pg.recv([recv], peer, 0))
        else:
            _wait(pg.recv([recv], peer, 0))
            _wait(pg.send([send], peer, 0))

    def _shift(self, pg, me: int, size: int, send: torch.Tensor,
               recv: torch.Tensor):
        """Send to the right neighbour, receive from the left one: even
        ranks send first, odd ranks receive first (a ring of blocking
        sends then never closes into a cycle)."""
        right, left = (me + 1) % size, (me - 1) % size
        if me % 2 == 0:
            _wait(pg.send([send], right, 0))
            _wait(pg.recv([recv], left, 0))
        else:
            _wait(pg.recv([recv], left, 0))
            _wait(pg.send([send], right, 0))

    def _ring_reduce_scatter(self, pg, me: int, size: int,
                             chunks: List[torch.Tensor]) -> torch.Tensor:
        """Neighbour ring over ``size`` equal chunks (modified in place):
        after size - 1 steps this member holds the reduced chunk
        (me + 1) % size, summed in ring order from that chunk's next
        member on."""
        buf = torch.empty_like(chunks[0])
        for s in range(size - 1):
            send_c = (me - s) % size
            recv_c = (me - s - 1) % size
            self._shift(pg, me, size, chunks[send_c], buf)
            chunks[recv_c] = buf + chunks[recv_c]
        return chunks[(me + 1) % size]

    def _ring_allgather(self, pg, me: int, size: int,
                        chunks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Complete ``chunks`` when this member holds chunk (me + 1) %
        size: size - 1 neighbour steps pass each reduced chunk on."""
        for s in range(size - 1):
            send_c = (me + 1 - s) % size
            recv_c = (me - s) % size
            buf = torch.empty_like(chunks[0])
            self._shift(pg, me, size, chunks[send_c], buf)
            chunks[recv_c] = buf
        return chunks

    def _decomposed_allreduce(self, tensor: torch.Tensor, plan: comp.Plan):
        """Planner-built lossless variants in the payload's own dtype: the
        explicit ring or recursive halving-doubling ("tree")."""
        w, me = self._world_size, self._rank
        flat = tensor.detach().reshape(-1)
        n = flat.numel()
        padded = F.pad(flat, (0, (-n) % w)).contiguous()
        pg = self._pg(padded)
        if plan.algorithm == comp.ALG_RING:
            chunks = list(padded.clone().chunk(w))
            self._ring_reduce_scatter(pg, me, w, chunks)
            out = torch.cat(self._ring_allgather(pg, me, w, chunks))
        else:
            if w & (w - 1):
                raise ValueError(
                    f"tree allreduce needs a power-of-two world, got {w}")
            # reduce-scatter by recursive halving (MSB first): keep the half
            # matching this rank's bit, send the other to rank ^ mask
            cur = padded.clone()
            masks = []
            mask = w // 2
            while mask >= 1:
                masks.append(mask)
                mask //= 2
            for m in masks:
                half = cur.numel() // 2
                lo, hi = cur[:half], cur[half:]
                bit = (me & m) != 0
                send, keep = (lo, hi) if bit else (hi, lo)
                got = torch.empty_like(keep)
                self._exchange(pg, me, me ^ m, send.contiguous(), got)
                cur = keep + got
            # allgather by recursive doubling, in bit order
            for m in reversed(masks):
                got = torch.empty_like(cur)
                self._exchange(pg, me, me ^ m, cur, got)
                cur = torch.cat([got, cur] if me & m else [cur, got])
            out = cur
        self.last_backend = pg.name()
        wire, inter = comp.estimate_wire_bytes(
            plan.algorithm, comp.SCHEME_NONE,
            padded.numel() * padded.element_size(), w)
        stats = comp.OpStats(
            logical_bytes=n * tensor.element_size(), wire_bytes=wire,
            algorithm=plan.algorithm, scheme=comp.SCHEME_NONE,
            inter_slice_bytes=inter)
        return out[:n].reshape(tensor.shape), stats

    def _quantize(self, flat: torch.Tensor, op: str, spec, granule: int):
        """(codes, scales, quant error): the fold-residual -> quantize ->
        update-residual sequence, on the host through the copied numpy
        codec (``ef_quantize``) for a CPU tensor and on the card through
        the torch codec (bit for bit the numpy one's) for a CUDA tensor,
        whose error feedback keeps an fp32 residual on the card."""
        if not flat.is_cuda:
            codes, scales, _deq, qerr = comp.ef_quantize(
                self._group_name, op, flat.float().numpy(), spec,
                pad_granule=granule)
            return torch.from_numpy(codes), torch.from_numpy(scales), qerr
        folded = flat.float()
        key = (op, tuple(flat.shape))
        if spec.error_feedback and key in self._residuals:
            folded = folded + self._residuals[key]
        padded = F.pad(folded, (0, (-folded.numel()) % granule))
        codes, scales = comp.torch_quantize_blocks(padded, spec.block_size)
        if spec.error_feedback:
            back = comp.torch_dequantize_blocks(codes, scales,
                                                spec.block_size)
            self._residuals[key] = folded - back[:folded.numel()]
        return codes, scales, -1.0  # unmeasured on the card: no host sync

    @staticmethod
    def _accumulate(parts: List[torch.Tensor], accum_dtype: str):
        """The sum over ranks in rank order in fp32, rounded once to
        ``accum_dtype`` (EQuARX: bf16), back in fp32."""
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p
        return acc.to(getattr(torch, accum_dtype)).float()

    def _quantized_allreduce(self, tensor: torch.Tensor, plan: comp.Plan):
        """EQuARX two-phase: int8 codes and per-block scales through
        all_to_all (each rank receives every rank's codes for its shard),
        dequantized and summed (``_accumulate``), requantized, allgathered,
        dequantized — every rank gets the same bits."""
        spec = plan.spec
        bs, w = spec.block_size, self._world_size
        flat = tensor.detach().reshape(-1)
        n = flat.numel()
        codes, scales, qerr = self._quantize(flat, "allreduce", spec, w * bs)
        pg = self._pg(codes)
        shard, shard_nb = codes.numel() // w, scales.numel() // w
        ca, sa = torch.empty_like(codes), torch.empty_like(scales)
        _wait(pg.alltoall_base(ca, codes, [], [], dist.AllToAllOptions()))
        _wait(pg.alltoall_base(sa, scales, [], [], dist.AllToAllOptions()))
        parts = [comp.torch_dequantize_blocks(ca[r * shard:(r + 1) * shard],
                                              sa[r * shard_nb:
                                                 (r + 1) * shard_nb], bs)
                 for r in range(w)]
        red = self._accumulate(parts, spec.accum_dtype)
        c2, s2 = comp.torch_quantize_blocks(red, bs)
        cg = [torch.empty_like(c2) for _ in range(w)]
        sg = [torch.empty_like(s2) for _ in range(w)]
        _wait(pg.allgather([cg], [c2]))
        _wait(pg.allgather([sg], [s2]))
        out = comp.torch_dequantize_blocks(torch.cat(cg), torch.cat(sg), bs)
        self.last_backend = pg.name()
        wire = codes.numel() + scales.numel() * 4
        stats = comp.OpStats(
            logical_bytes=n * tensor.element_size(),
            # phase 1 sends this rank's codes once; phase 2 re-sends its
            # 1/world requantized shard
            wire_bytes=wire + wire // max(w, 1),
            algorithm=comp.ALG_FLAT, scheme=plan.scheme, quant_error=qerr)
        return out[:n].reshape(tensor.shape).to(tensor.dtype), stats

    def _hierarchical_allreduce(self, tensor: torch.Tensor,
                                plan: comp.Plan):
        """Two levels over contiguous slices of ``slice_size`` ranks: a
        ring reduce-scatter inside the slice, the shard reduced across
        slices among same-index members (int8 when the spec says so: its
        codes and scales allgathered, summed in slice order), a ring
        allgather inside the slice."""
        spec = plan.spec
        bs, ss = spec.block_size, plan.slice_size
        nslices = self._world_size // ss
        sid, idx = self._rank // ss, self._rank % ss
        flat = tensor.detach().reshape(-1)
        n = flat.numel()
        padded = F.pad(flat.float(), (0, (-n) % (ss * bs))).contiguous()
        kind = "cuda" if padded.is_cuda else "cpu"
        intra = self._subgroup(kind, [sid * ss + j for j in range(ss)])
        cross = self._subgroup(kind, [s * ss + idx for s in range(nslices)])
        chunks = list(padded.clone().chunk(ss))
        # after the ring this member holds chunk (idx + 1) % ss
        mine = self._ring_reduce_scatter(intra, idx, ss, chunks)
        if plan.scheme == comp.SCHEME_INT8 and nslices > 1:
            c, s = comp.torch_quantize_blocks(mine, bs)
            cg = [torch.empty_like(c) for _ in range(nslices)]
            sg = [torch.empty_like(s) for _ in range(nslices)]
            _wait(cross.allgather([cg], [c]))
            _wait(cross.allgather([sg], [s]))
            reduced = self._accumulate(
                [comp.torch_dequantize_blocks(cg[j], sg[j], bs)
                 for j in range(nslices)], spec.accum_dtype)
            wire_inter = c.numel() + s.numel() * 4
        else:
            parts = [torch.empty_like(mine) for _ in range(nslices)]
            _wait(cross.allgather([parts], [mine]))
            reduced = self._accumulate(parts, "float32")
            wire_inter = mine.numel() * mine.element_size()
        chunks[(idx + 1) % ss] = reduced
        out = torch.cat(self._ring_allgather(intra, idx, ss, chunks))
        self.last_backend = intra.name()
        wire, inter = comp.estimate_wire_bytes(
            comp.ALG_HIERARCHICAL, plan.scheme,
            padded.numel() * padded.element_size(), self._world_size, ss, bs)
        stats = comp.OpStats(
            logical_bytes=n * tensor.element_size(), wire_bytes=wire,
            algorithm=comp.ALG_HIERARCHICAL, scheme=plan.scheme,
            quant_error=-1.0 if plan.scheme == comp.SCHEME_INT8 else 0.0,
            inter_slice_bytes=wire_inter if nslices > 1 else inter)
        return out[:n].reshape(tensor.shape).to(tensor.dtype), stats

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        tensor = torch.as_tensor(tensor)
        out = tensor.detach().clone().contiguous()

        def run():
            pg = self._pg(out)
            opts = dist.ReduceOptions()
            opts.rootRank = dst_rank
            opts.reduceOp = _TORCH_OPS[op]
            _wait(pg.reduce([out], opts))
            self.last_backend = pg.name()
            return out if self._rank == dst_rank else tensor

        return self._run("reduce", run)

    def broadcast(self, tensor, src_rank: int = 0):
        tensor = torch.as_tensor(tensor)
        out = tensor.detach().clone().contiguous()

        def run():
            pg = self._pg(out)
            opts = dist.BroadcastOptions()
            opts.rootRank = src_rank
            _wait(pg.broadcast([out], opts))
            self.last_backend = pg.name()
            return out

        return self._run("broadcast", run)

    def allgather(self, tensor) -> List[Any]:
        tensor = torch.as_tensor(tensor).detach().contiguous()

        def run():
            pg = self._pg(tensor)
            outs = [torch.empty_like(tensor) for _ in range(self._world_size)]
            _wait(pg.allgather([outs], [tensor]))
            self.last_backend = pg.name()
            return outs

        return self._run("allgather", run)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        tensor = torch.as_tensor(tensor).detach().contiguous()
        if tensor.shape[0] % self._world_size:
            raise ValueError(
                f"reducescatter dim0 {tensor.shape[0]} not divisible by "
                f"{self._world_size}")

        def run():
            pg = self._pg(tensor)
            out = torch.empty_like(tensor[:tensor.shape[0]
                                          // self._world_size])
            opts = dist.ReduceScatterOptions()
            opts.reduceOp = _TORCH_OPS[op]
            _wait(pg.reduce_scatter(
                [out], [list(tensor.chunk(self._world_size))], opts))
            self.last_backend = pg.name()
            return out

        return self._run("reducescatter", run)

    def barrier(self):
        """Through NCCL once the group has run a CUDA operation (a device
        barrier), through gloo before."""
        def run():
            pg = self._nccl if self._nccl is not None else self._gloo
            _wait(pg.barrier())
            self.last_backend = pg.name()

        self._run("barrier", run)

    # -- p2p ----------------------------------------------------------------
    # A header (dtype, device, shape) goes over gloo first, so the receiver
    # allocates; the payload then rides NCCL for a CUDA tensor, gloo else.

    def send(self, tensor, dst_rank: int):
        tensor = torch.as_tensor(tensor).detach().contiguous()
        if tensor.dim() > _MAX_DIMS:
            raise ValueError(f"send takes at most {_MAX_DIMS} dims")
        header = torch.zeros(3 + _MAX_DIMS, dtype=torch.int64)
        header[0] = _DTYPES.index(tensor.dtype)
        header[1] = int(tensor.is_cuda)
        header[2] = tensor.dim()
        header[3:3 + tensor.dim()] = torch.tensor(tensor.shape)

        def run():
            _wait(self._gloo.send([header], dst_rank, 0))
            pg = self._pg(tensor)
            _wait(pg.send([tensor], dst_rank, 1))
            self.last_backend = pg.name()

        self._run("send", run)

    def recv(self, src_rank: int):
        def run():
            header = torch.empty(3 + _MAX_DIMS, dtype=torch.int64)
            _wait(self._gloo.recv([header], src_rank, 0))
            dtype = _DTYPES[int(header[0])]
            shape = [int(d) for d in header[3:3 + int(header[2])]]
            device = "cuda" if int(header[1]) else "cpu"
            out = torch.empty(shape, dtype=dtype, device=device)
            pg = self._pg(out)
            _wait(pg.recv([out], src_rank, 1))
            self.last_backend = pg.name()
            return out

        return self._run("recv", run)

    def destroy(self):
        """Shut the group's process groups and its TCPStore down."""
        if self._world_size > 1:
            import ray_tpu_torch

            try:
                ray_tpu_torch.get(get_or_create_store().leave_group.remote(
                    self._group_name, self._rank))
            except Exception:  # noqa: BLE001 — store may already be gone
                pass
        for pg in [self._gloo, self._nccl, *self._subgroups.values()]:
            if pg is not None and hasattr(pg, "shutdown"):
                try:
                    pg.shutdown()
                except Exception:  # noqa: BLE001 — a member may be gone
                    pass
        self._gloo = self._nccl = None
        self._subgroups.clear()
        self._residuals.clear()
        self._tcp = None
        self._aborted = "destroyed"
        super().destroy()


def _node_id():
    try:
        from ray_tpu_torch._private.worker import get_global_worker

        nid = get_global_worker().node_id
        return nid.hex() if nid is not None else None
    except Exception:  # noqa: BLE001 — driver-less contexts
        return None

"""Device meshes, canonical sharding axes, and one rank's slice of a tree.

Port of ``ray_tpu/parallel/mesh.py``.  The canonical axes and their order
are the JAX package's (outermost to innermost):

  pipeline — pipeline stages (``parallel.pipeline``)
  data     — pure data parallelism
  fsdp     — data parallelism with parameters sharded over the axis
  expert   — expert parallelism for MoE layers
  context  — sequence (context) parallelism
  tensor   — megatron-style tensor parallelism

A JAX ``Mesh`` is one program's view of every device; GSPMD places each
shard and inserts the collectives.  PyTorch's idiom is one process per
card instead, each running the same program on its own shard and running
the collectives GSPMD would insert itself.  So the port's :class:`Mesh`
is ONE RANK's view: the axis sizes, this process's global ``rank`` and its
coordinate on every axis (``coords``; ranks are laid out row-major over
:data:`MESH_AXES`, later axes innermost, as ``jax.make_mesh`` lays out
``devices[:n]``), its device, the names of every member's device, and one
:class:`TensorGroup` per axis joining the ranks that differ only on that
axis (``groups``), plus one over each combination of the batch axes the
training step sums over (:data:`GROUP_KEYS`: Llama's ``("data",
"fsdp")``, MoE's ``("data", "fsdp", "expert")`` and ``("data",
"expert")``).
``MeshSpec.build(rank=..., store=...)`` makes the groups over a shared
``torch.distributed`` store (or ``address="host:port"``, rank 0 serving
it).  ``mesh.group`` is the tensor axis's group (what the serving programs
reduce through).

A partition spec is a tuple with one mesh-axis name, a tuple of names or
None per tensor dim (``P(None, "tensor")``, ``P(("data", "fsdp"), None)``),
as ``jax.sharding.PartitionSpec`` spells it.  :func:`shard_pytree` takes
each rank's slice of a full tree by its specs: contiguous equal blocks
along each sharded dim, a tuple of axes splitting the dim with the first
axis major, which is the layout GSPMD gives a ``NamedSharding``.

:class:`TensorGroup` runs an axis's collectives in place on torch process
groups (an ``NCCLGroup``'s: NCCL for CUDA tensors, gloo for CPU tensors,
or gloo for both when asked), as calls a CUDA graph can capture under
NCCL, plus the host-object broadcast a tensor-parallel engine's leader
sends its ranks.  It books each op's process group on the ``NCCLGroup``'s
``last_backend``.  The differentiable collectives of sharded training are
in ``parallel.functional``.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

MESH_AXES = ("pipeline", "data", "fsdp", "expert", "context", "tensor")

# batch dims of activations/token arrays are sharded over both DP axes
BATCH_AXES = ("data", "fsdp")
# an MoE model's activations take the expert axis as a further batch axis
MOE_BATCH_AXES = ("data", "fsdp", "expert")
# the groups a built mesh holds: one per axis, then the batch-axis
# combinations a gradient is summed over (the batch axes a leaf is not
# sharded on), each shared with a smaller group where its other axes are 1
GROUP_KEYS = tuple((a,) for a in MESH_AXES) + (
    BATCH_AXES, ("data", "expert"), MOE_BATCH_AXES)


def P(*axes) -> tuple:
    """A partition spec: one mesh-axis name, a tuple of names, or None per
    tensor dim."""
    return tuple(axes)


def batch_spec(*, context_sharded: bool = False) -> tuple:
    """Partition spec for [batch, seq, ...] arrays."""
    return P(BATCH_AXES, "context" if context_sharded else None)


def coords_of(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on every axis: row-major over
    :data:`MESH_AXES` (later axes innermost)."""
    out = {}
    for a in reversed(MESH_AXES):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in MESH_AXES}


def rank_of(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    """The global rank at ``coords`` (the inverse of :func:`coords_of`)."""
    r = 0
    for a in MESH_AXES:
        r = r * shape[a] + coords[a]
    return r


def group_members(shape: Dict[str, int], rank: int, axes: Sequence[str]) -> list:
    """The global ranks that differ from ``rank`` only on ``axes``, in the
    order of their coordinates on ``axes`` (the first axis major)."""
    base = coords_of(shape, rank)
    members = [dict(base)]
    for a in axes:
        members = [dict(c, **{a: i}) for c in members for i in range(shape[a])]
    return [rank_of(shape, c) for c in members]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees (the JAX package's fields; the product
    is the number of ranks).  ``num_slices`` stays for the config's shape:
    one host's cards form one slice here."""

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    context: int = 1
    tensor: int = 1
    pipeline: int = 1
    num_slices: int = 1

    @property
    def num_devices(self) -> int:
        return (self.pipeline * self.data * self.fsdp * self.expert
                * self.context * self.tensor)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: int(getattr(self, a)) for a in MESH_AXES}

    def build(self, *, rank: int = 0, group: Optional["TensorGroup"] = None,
              device=None, devices: Optional[Sequence] = None, store=None,
              address: Optional[str] = None, name: str = "mesh",
              device_backend: str = "nccl") -> "Mesh":
        """Rank ``rank``'s view of this mesh (see :class:`Mesh`).

        With ``store`` (a ``torch.distributed.Store`` every rank shares)
        or ``address`` ("host:port": rank 0 serves a ``TCPStore`` there,
        the others connect), the mesh gets its groups: one ``NCCLGroup``
        per axis above one rank, named ``{name}/{axis}/...``, and one over
        the batch axes.  ``device_backend``
        is the groups' (``TensorGroup``): "gloo" stages CUDA tensors
        through the host.  ``group``: the tensor axis's group, for a
        tensor-only mesh made by a caller (the serving engines)."""
        if self.data % self.num_slices:
            raise ValueError(
                f"data={self.data} must be a multiple of num_slices="
                f"{self.num_slices}")
        n = self.num_devices
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n} ranks")
        groups = None
        if address is not None and store is None:
            import datetime

            host, port = address.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), n, rank == 0,
                                  timeout=datetime.timedelta(seconds=300),
                                  wait_for_workers=False)
        if store is not None:
            if group is not None:
                raise ValueError("pass a store or a tensor group, not both")
            groups = _make_groups(self.shape, rank, store, name,
                                  device_backend)
        return Mesh(self.shape, rank=rank, group=group, device=device,
                    devices=devices, groups=groups)

    @classmethod
    def for_devices(cls, n: int, *, tensor: int = 1,
                    context: int = 1) -> "MeshSpec":
        """A sensible default: given n devices, put the remainder on fsdp."""
        rem, r = divmod(n, tensor * context)
        if r:
            raise ValueError(
                f"{n} devices not divisible by tensor*context="
                f"{tensor * context}")
        return cls(data=1, fsdp=rem, context=context, tensor=tensor)


def _make_groups(shape, rank, store, name, device_backend):
    """{axis or axes tuple: TensorGroup} for ``rank`` over
    :data:`GROUP_KEYS`: each group joins the ranks that differ from it
    only on those axes.  A key whose axes above one rank are another
    key's shares that key's group."""
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    groups, by_axes = {}, {}
    for axes in GROUP_KEYS:
        live = tuple(a for a in axes if shape[a] > 1)
        if not live:
            continue
        key = axes if len(axes) > 1 else axes[0]
        if live not in by_axes:
            members = group_members(shape, rank, live)
            tag = "-".join(str(m) for m in members)
            by_axes[live] = TensorGroup(NCCLGroup(
                len(members), members.index(rank),
                f"{name}/{'+'.join(live)}/{tag}", store=store), device_backend)
        groups[key] = by_axes[live]
    return groups


class TensorGroup:
    """One mesh axis's collectives over an ``NCCLGroup``'s process groups,
    in place and without a host wait, so a CUDA graph captures them under
    NCCL (the name is the tensor axis's, the first one served).

    ``device_backend``: "nccl" (default) reduces CUDA tensors through the
    group's NCCL process group; "gloo" through its gloo one, which stages
    CUDA tensors through the host (and cannot be captured in a graph).
    CPU tensors always take gloo.  Host objects (a leader's commands)
    travel over gloo."""

    def __init__(self, group, device_backend: str = "nccl"):
        if device_backend not in ("nccl", "gloo"):
            raise ValueError(
                f"device_backend must be 'nccl' or 'gloo' (got "
                f"{device_backend!r})")
        self.group = group
        self.rank = group.rank
        self.size = group.world_size
        self.device_backend = device_backend

    def capturable(self, device) -> bool:
        """Whether this group's ops on ``device`` tensors can be captured
        in a CUDA graph (NCCL can; gloo waits on the host)."""
        return torch.device(device).type != "cuda" or self.device_backend == "nccl"

    def _pg(self, t: torch.Tensor):
        if t.is_cuda and self.device_backend == "gloo":
            pg = self.group._gloo
        else:
            pg = self.group._pg(t)
        self.group.last_backend = pg.name()
        return pg

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through a host copy: a CUDA tensor on the
        gloo device backend (gloo's own CUDA paths cover only some ops)."""
        return t.is_cuda and self.device_backend == "gloo"

    def allreduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="max"``: its largest value) over the group,
        in place (contiguous ``t``)."""
        self.allreduce_async_(t, op).wait()
        return t

    def allreduce_async_(self, t: torch.Tensor, op: str = "sum"):
        """Start reducing ``t`` over the group in place (``op``: "sum" or
        "max"); returns the work (``wait()`` it before reading ``t``)."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        pg = self._pg(t)
        if not self._staged(t):
            return pg.allreduce([t], opts)
        host = t.cpu()
        return _HostWork(pg.allreduce([host], opts), lambda: t.copy_(host))

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every member's ``t`` concatenated along ``dim``, in rank order
        (one gather into a [size, ...] buffer; a copy only to move the
        member index next to ``dim`` when ``dim`` is not the first)."""
        src = t.cpu() if self._staged(t) else t.contiguous()
        dim = dim % t.dim()
        out = src.new_empty((self.size,) + tuple(src.shape))
        self._pg(t)._allgather_base(out.view((-1,) + tuple(src.shape[1:])),
                                    src).wait()
        shape = list(src.shape)
        shape[dim] *= self.size
        if dim:
            out = out.movedim(0, dim)
        return out.reshape(shape).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``t`` summed over the group, this member's block of ``dim``
        (equal contiguous blocks in rank order; a copy only to bring the
        blocks of a ``dim`` that is not the first together)."""
        src = t.cpu() if self._staged(t) else t
        dim = dim % t.dim()
        if src.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                             f"over {self.size} members")
        blocks = src.unflatten(dim, (self.size, -1))
        if dim:
            blocks = blocks.movedim(dim, 0)
        blocks = blocks.contiguous()
        out = blocks.new_empty(blocks.shape[1:])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._pg(t)._reduce_scatter_base(
            out, blocks.view((-1,) + tuple(out.shape[1:])), opts).wait()
        return out.to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The all-to-all over equal blocks of dim 0: block j of ``t`` goes
        to member j, and block i of the result came from member i (a
        contiguous ``t`` whose first dim divides over the group)."""
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not divide "
                             f"over {self.size} members")
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = torch.empty_like(src)
        self._pg(t).alltoall_base(out, src, [], [],
                                  dist.AllToAllOptions()).wait()
        return out.to(t.device)

    def permute(self, send: torch.Tensor, dst: Optional[int],
                src: Optional[int]) -> torch.Tensor:
        """Send ``send`` to member ``dst`` and receive a tensor of its
        shape from member ``src`` (None: none); zeros where nothing
        arrives, as ``lax.ppermute`` gives.

        A member below its destination sends first, the others receive
        first; both are posted before either is waited on.  NCCL runs a
        pair's (or a member's) point-to-point calls on one stream in the
        order they were posted, each blocking until its peer's matching
        call runs: with a swap (``dst == src``) the lower member sends
        first, as its peer receives first, and in a cycle of sends the
        members above their destinations receive first, so no cycle of
        members waits on itself (gloo's calls are asynchronous either
        way)."""
        if dst == self.rank and src == self.rank:
            return send.clone()
        out = send
        send = send.cpu() if self._staged(send) else send.contiguous()
        recv = torch.zeros_like(send)
        pg = self._pg(out)
        ops = []
        if src is not None:
            ops.append(lambda: pg.recv([recv], src, 0))
        if dst is not None:
            post_send = lambda: pg.send([send], dst, 0)  # noqa: E731
            ops.insert(0 if self.rank < dst else len(ops), post_send)
        for w in [op() for op in ops]:
            w.wait()
        return recv.to(out.device)

    def exchange(self, send: torch.Tensor, peer: int) -> torch.Tensor:
        """Swap ``send`` with ``peer``'s (same shape; the lower member
        sends first)."""
        return self.permute(send, peer, peer)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """``obj`` from rank ``src`` on every member (pickled over gloo);
        the other members pass nothing and get it back."""
        pg = self.group._gloo
        size = torch.zeros(1, dtype=torch.int64)
        if self.rank == src:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8)
            size[0] = data.numel()
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        pg.broadcast([size], opts).wait()
        if self.rank != src:
            data = torch.empty(int(size[0]), dtype=torch.uint8)
        pg.broadcast([data], opts).wait()
        return obj if self.rank == src else pickle.loads(data.numpy().tobytes())

    def destroy(self) -> None:
        self.group.destroy()


class _HostWork:
    """A collective's work on a host copy: ``wait()`` waits, then copies
    the result back to the device tensor."""

    def __init__(self, work, copy_back):
        self.work, self.copy_back = work, copy_back

    def wait(self):
        self.work.wait()
        self.copy_back()
        return True


class Mesh:
    """One rank's view of a device mesh: ``shape`` (axis -> size over
    :data:`MESH_AXES`), this process's global ``rank`` and its ``coords``
    (axis -> coordinate; for a tensor-only mesh the rank is the tensor
    coordinate), its ``device``, ``devices`` (every member's device name,
    in rank order), ``groups`` (axis, or a tuple of axes of
    :data:`GROUP_KEYS` -> :class:`TensorGroup`; an axis without one runs no
    collective, which a one-rank axis needs none of) and ``group``, the
    tensor axis's."""

    axis_names = MESH_AXES

    def __init__(self, shape: Dict[str, int], *, rank: int = 0,
                 group: Optional[TensorGroup] = None, device=None,
                 devices: Optional[Sequence] = None,
                 groups: Optional[Dict[Any, TensorGroup]] = None):
        unknown = set(shape) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        self.shape = {a: int(shape.get(a, 1)) for a in MESH_AXES}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size} ranks")
        self.coords = coords_of(self.shape, self.rank)
        self.groups = dict(groups or {})
        if group is not None:
            self.groups["tensor"] = group
        self.device = torch.device(device if device is not None else "cpu")
        for axes, g in self.groups.items():
            if g is None:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            size = math.prod(self.shape[a] for a in names)
            at = 0
            for a in names:
                at = at * self.shape[a] + self.coords[a]
            if g.size != size or g.rank != at:
                raise ValueError(
                    f"group of {g.size} (rank {g.rank}) does not match the "
                    f"{'+'.join(names)} axis of {size} (rank {at})")
        self.devices = ([str(d) for d in devices] if devices is not None
                        else [str(self.device)] * self.size)

    @property
    def group(self) -> Optional[TensorGroup]:
        return self.groups.get("tensor")

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

    def axis_group(self, axes) -> Optional[TensorGroup]:
        """The group over ``axes`` (a name or a tuple of :data:`GROUP_KEYS`),
        or None."""
        return self.groups.get(axes)

    def check_groups(self, axes: Sequence[str]) -> None:
        """Raise unless every axis in ``axes`` above one rank has a group."""
        missing = [a for a in axes if self.shape[a] > 1
                   and self.groups.get(a) is None]
        if missing:
            raise ValueError(
                f"mesh axes {missing} have no group: build the mesh with "
                f"MeshSpec.build(rank=..., store=...) or address=")

    def destroy(self) -> None:
        """Destroy every group this mesh made or was given."""
        seen = set()
        for g in self.groups.values():
            if g is not None and id(g) not in seen:
                seen.add(id(g))
                g.destroy()

    def __repr__(self) -> str:
        axes = {a: n for a, n in self.shape.items() if n > 1}
        return (f"Mesh({axes or {'tensor': 1}}, rank={self.rank}, "
                f"device={self.device})")


def local_mesh(spec: Optional[MeshSpec] = None, *, rank: int = 0,
               group: Optional[TensorGroup] = None, device=None,
               devices: Optional[Sequence] = None, **build) -> Mesh:
    """Rank ``rank``'s mesh (default spec: one rank); further keywords go
    to :meth:`MeshSpec.build`."""
    spec = spec or MeshSpec()
    return spec.build(rank=rank, group=group, device=device, devices=devices,
                      **build)


def shard_bounds(shape: Sequence[int], spec: Sequence, mesh: Mesh,
                 rank: Optional[int] = None) -> list:
    """(start, size) on each dim of rank ``rank``'s (default
    ``mesh.rank``'s) block of an array of ``shape`` by partition spec
    ``spec``: contiguous equal blocks along each sharded dim, a tuple of
    axes splitting the dim with its first axis major (the layout of
    ``jax.sharding.NamedSharding``)."""
    coords = mesh.coords if rank is None else coords_of(mesh.shape, rank)
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than {tuple(shape)}")
    out = [(0, int(n)) for n in shape]
    for dim, axis in enumerate(spec):
        axes = [a for a in (axis if isinstance(axis, tuple) else (axis,))
                if a is not None]
        n = math.prod(mesh.shape[a] for a in axes)
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} does not divide over mesh "
                f"axes {axes} of {n}")
        at = 0
        for a in axes:
            at = at * mesh.shape[a] + coords[a]
        b = shape[dim] // n
        out[dim] = (at * b, b)
    return out


def shard_slice(x: torch.Tensor, spec: Sequence, mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s (default ``mesh.rank``'s) block of ``x`` by
    partition spec ``spec`` (:func:`shard_bounds`), a view (``x`` itself
    where no axis above one rank shards it)."""
    for dim, (start, size) in enumerate(shard_bounds(x.shape, spec, mesh,
                                                     rank)):
        if size != x.shape[dim]:
            x = x.narrow(dim, start, size)
    return x


def sharded_axes(spec: Sequence) -> tuple:
    """The mesh axes a partition spec shards over, in spec order."""
    out = []
    for axis in spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


def shard_pytree(tree, spec_tree, mesh: Mesh, device=None,
                 rank: Optional[int] = None):
    """Each leaf's slice for rank ``rank`` (default ``mesh.rank``) by the
    matching spec (a nested dict of specs shaped like ``tree``; a leaf
    ``tree`` takes ``spec_tree`` itself), contiguous, on ``device``
    (default: the mesh's).  Leaves without a spec are kept whole."""
    dev = mesh.device if device is None else torch.device(device)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, (s or {}).get(k) if isinstance(s, dict) else s)
                    for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        if s is None:
            return t.to(dev).contiguous()
        part = shard_slice(t, s, mesh, rank)
        if part is t:  # nothing sharded (a one-rank axis): no copy
            return t.to(dev).contiguous()
        # a copy: a view would keep the whole leaf alive (a move to
        # another device copies already)
        out = part.to(dev)
        if out is part or not out.is_contiguous():
            out = out.clone(memory_format=torch.contiguous_format)
        return out

    return walk(tree, spec_tree)

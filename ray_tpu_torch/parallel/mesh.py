"""Device meshes, canonical sharding axes, and one rank's slice of a tree.

Port of ``ray_tpu/parallel/mesh.py``.  The canonical axes and their order
are the JAX package's (outermost to innermost):

  pipeline — pipeline stages (ROADMAP A11's training half)
  data     — pure data parallelism
  fsdp     — data parallelism with parameters sharded over the axis
  expert   — expert parallelism for MoE layers
  context  — sequence (context) parallelism
  tensor   — megatron-style tensor parallelism

A JAX ``Mesh`` is one program's view of every device; GSPMD places each
shard and inserts the collectives.  PyTorch's idiom for tensor parallelism
is one process per card instead, each running the same program on its own
shard and reducing partial sums through a collective group.  So the port's
:class:`Mesh` is ONE RANK's view: the axis sizes, this process's
coordinate along ``"tensor"``, its device, the names of every member's
device, and the :class:`TensorGroup` that joins the members.  Only the
tensor axis is served so far; a mesh with another axis above 1 is refused
where it is used (ROADMAP A11's training half).

A partition spec is a tuple with one mesh-axis name (or None) per tensor
dim (``P(None, "tensor")``), as ``jax.sharding.PartitionSpec`` spells it.
:func:`shard_pytree` takes each rank's slice of a full tree by its specs:
contiguous equal blocks along each sharded dim, rank r holding block r,
which is the layout GSPMD gives a ``NamedSharding`` over one mesh axis.

:class:`TensorGroup` runs the tensor axis's collectives in place on torch
process groups (an ``NCCLGroup``'s: NCCL for CUDA tensors, gloo for CPU
tensors, or gloo for both when asked), as calls a CUDA graph can capture
under NCCL, plus the host-object broadcast a tensor-parallel engine's
leader sends its ranks.  It books each op's process group on the
``NCCLGroup``'s ``last_backend``.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

MESH_AXES = ("pipeline", "data", "fsdp", "expert", "context", "tensor")


def P(*axes) -> tuple:
    """A partition spec: one mesh-axis name (or None) per tensor dim."""
    return tuple(axes)


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
              device=None, devices: Optional[Sequence] = None) -> "Mesh":
        """Rank ``rank``'s view of this mesh (see :class:`Mesh`)."""
        if self.data % self.num_slices:
            raise ValueError(
                f"data={self.data} must be a multiple of num_slices="
                f"{self.num_slices}")
        return Mesh(self.shape, rank=rank, group=group, device=device,
                    devices=devices)

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


class TensorGroup:
    """The tensor axis's collectives over an ``NCCLGroup``'s process
    groups, in place and without a host wait, so a CUDA graph captures
    them under NCCL.

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

    def allreduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place (contiguous ``t``)."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._pg(t).allreduce([t], opts).wait()
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every member's ``t`` concatenated along ``dim``, in rank order."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._pg(t).allgather([outs], [t]).wait()
        return torch.cat(outs, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``t`` summed over the group, this member's block of ``dim``
        (equal contiguous blocks in rank order)."""
        parts = [c.contiguous() for c in t.chunk(self.size, dim=dim)]
        out = torch.empty_like(parts[self.rank])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._pg(t).reduce_scatter([out], [parts], opts).wait()
        return out

    def exchange(self, send: torch.Tensor, peer: int) -> torch.Tensor:
        """Swap ``send`` with ``peer``'s (same shape): the lower rank sends
        first, so blocking sends never wait on each other."""
        send = send.contiguous()
        recv = torch.empty_like(send)
        pg = self._pg(send)
        if self.rank < peer:
            pg.send([send], peer, 0).wait()
            pg.recv([recv], peer, 0).wait()
        else:
            pg.recv([recv], peer, 0).wait()
            pg.send([send], peer, 0).wait()
        return recv

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


class Mesh:
    """One rank's view of a device mesh: ``shape`` (axis -> size over
    :data:`MESH_AXES`), this process's coordinate ``rank`` along
    ``"tensor"``, its ``device``, ``devices`` (every member's device name,
    in rank order) and ``group``, the :class:`TensorGroup` joining the
    tensor axis's members (None for a one-rank mesh that runs no
    collective)."""

    axis_names = MESH_AXES

    def __init__(self, shape: Dict[str, int], *, rank: int = 0,
                 group: Optional[TensorGroup] = None, device=None,
                 devices: Optional[Sequence] = None):
        self.shape = {a: int(shape.get(a, 1)) for a in MESH_AXES}
        unknown = set(shape) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device if device is not None else "cpu")
        size = self.shape["tensor"]
        if not 0 <= self.rank < size:
            raise ValueError(f"rank {rank} outside a tensor axis of {size}")
        if group is not None and (group.size != size or group.rank != rank):
            raise ValueError(
                f"group of {group.size} (rank {group.rank}) does not match "
                f"the tensor axis of {size} (rank {rank})")
        if group is None and size > 1:
            raise ValueError(f"a tensor axis of {size} needs a group")
        self.devices = ([str(d) for d in devices] if devices is not None
                        else [str(self.device)] * size)

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

    def __repr__(self) -> str:
        axes = {a: n for a, n in self.shape.items() if n > 1}
        return (f"Mesh({axes or {'tensor': 1}}, rank={self.rank}, "
                f"device={self.device})")


def local_mesh(spec: Optional[MeshSpec] = None, *, rank: int = 0,
               group: Optional[TensorGroup] = None, device=None,
               devices: Optional[Sequence] = None) -> Mesh:
    """Rank ``rank``'s mesh over ``group`` (default spec: one rank)."""
    spec = spec or MeshSpec()
    return spec.build(rank=rank, group=group, device=device, devices=devices)


def shard_slice(x: torch.Tensor, spec: Sequence, mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s (default ``mesh.rank``'s) block of ``x`` by
    partition spec ``spec``: contiguous equal blocks along each dim named
    "tensor", a view."""
    rank = mesh.rank if rank is None else rank
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more dims than {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        axes = axis if isinstance(axis, tuple) else (axis,)
        for a in axes:
            if a is None:
                continue
            n = mesh.shape.get(a, 1)
            if a != "tensor" and n > 1:
                raise NotImplementedError(
                    f"sharding over mesh axis {a!r} is ROADMAP A11's "
                    f"training half; only 'tensor' is served")
            if a != "tensor" or n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of {tuple(x.shape)} does not divide over a "
                    f"tensor axis of {n}")
            b = x.shape[dim] // n
            x = x.narrow(dim, rank * b, b)
    return x


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

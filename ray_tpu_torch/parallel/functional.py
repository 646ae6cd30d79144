"""Differentiable collectives over one mesh axis's group: the collectives
GSPMD inserts into the JAX package's sharded step, written out for one
process per rank, each with the transpose JAX gives it.

    op              forward                      backward
    all_gather      gather blocks along dim      reduce-scatter along dim
    reduce_scatter  sum, keep this rank's block  all-gather along dim
    psum            sum over the group           identity
    pvary           identity                     sum over the group
    ppermute        send to perm's destination   the inverse permutation
    all_to_all      block j of dim 0 to member j the same all-to-all

``psum`` and ``pvary`` are each other's transposes, as ``lax.psum`` and
``lax.pvary`` are under ``shard_map``: every rank runs its own backward
from the same replicated loss, so a value summed in the forward gets its
cotangent once per rank (identity), and a replicated value read by every
rank's own partial product collects the partial cotangents (a sum).
Megatron's column-parallel input is ``pvary``, its row-parallel output
``psum``; fsdp's per-layer weight gather is ``all_gather``, whose backward
reduce-scatters the gradient.

``group`` is a ``parallel.mesh.TensorGroup`` or None (a one-rank axis
without a group: every op is the identity and runs nothing).  A group of
one member still runs its collective, so a world-size-1 mesh exercises
them.  A failing collective raises (the group is poisoned); nothing falls
back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, dtype):
        ctx.group, ctx.dim, ctx.in_dtype = group, dim, x.dtype
        if dtype is not None:
            x = x.to(dtype)
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # the sum runs in the input's dtype: an fp32 master shard gets its
        # gradient summed in fp32, as the cast's transpose widens it first
        g = ctx.group.reduce_scatter(g.to(ctx.in_dtype), dim=ctx.dim)
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, dim=ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.allreduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.allreduce_(g.contiguous().clone()), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        # block i of the output came from member i's block r: the
        # transpose sends it back, which is the same exchange
        return ctx.group.all_to_all(g.contiguous()), None


def _route(perm: Sequence[Tuple[int, int]], rank: int):
    """(destination, source) of ``rank`` under ``perm`` (None: none)."""
    dst = [d for s, d in perm if s == rank]
    src = [s for s, d in perm if d == rank]
    return (dst[0] if dst else None), (src[0] if src else None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.group, ctx.perm = group, perm
        dst, src = _route(perm, group.rank)
        return tuple(group.permute(x, dst, src) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        inverse = [(d, s) for s, d in ctx.perm]
        dst, src = _route(inverse, ctx.group.rank)
        # an output the loss does not read has a zero gradient (autograd
        # materialises it), so every member sends and receives in step
        return (None, None) + tuple(ctx.group.permute(g, dst, src)
                                    for g in gs)


def all_gather(x: torch.Tensor, group, dim: int,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Every member's block of ``x`` concatenated along ``dim`` in member
    order (cast to ``dtype`` first, when given); the backward
    reduce-scatters the gradient in ``x``'s dtype."""
    if group is None:
        return x if dtype is None else x.to(dtype)
    return _AllGather.apply(x, group, dim, dtype)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over the group, this member's block of ``dim``; the
    backward all-gathers."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group (a new tensor); identity backward."""
    if group is None:
        return x
    return _Psum.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group."""
    if group is None:
        return x
    return _Pvary.apply(x, group)


def ppermute(xs, group, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute``: member ``s`` sends each tensor of ``xs`` (one
    tensor or a tuple) to ``d`` for each ``(s, d)`` in ``perm``; a member
    nothing is sent to gets zeros.  The backward sends the gradients by
    the inverse permutation."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    if group is None:
        out = xs
    else:
        out = _PPermute.apply(group, tuple(map(tuple, perm)), *xs)
    return out[0] if single else tuple(out)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all over equal blocks of dim 0: block j of ``x`` goes to
    member j, block i of the result came from member i; its own
    transpose, so the backward runs the same exchange on the gradient."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


def ring_perm(n: int) -> list:
    """The ring shift ``i -> i + 1 (mod n)``."""
    return [(i, (i + 1) % n) for i in range(n)]

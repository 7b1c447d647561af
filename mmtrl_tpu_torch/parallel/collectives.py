"""Differentiable collectives over the axes of a mesh.

``jax.lax`` gives the JAX package ``psum``, ``ppermute``, ``all_gather``
and ``psum_scatter`` inside ``shard_map``, and ``jax.grad`` transposes them.
These are their counterparts on ``torch.distributed``, each a
``torch.autograd.Function`` over the process group of one mesh axis (or of
several), with the backward that makes a rank's gradients those of the
one-device program:

- ``psum``: all-reduce forward, identity backward (Megatron's g).  Every
  rank then holds the sum, and each one's backward carries only its own
  terms' share, as JAX's ``psum`` in ``shard_map``; a step that needs the
  whole gradient sums it afterwards.  ``torch.distributed.nn``'s
  all-reduce sums the gradient in its backward too, which used on a loss
  multiplies every gradient by the group's size.
- ``enter``: identity forward, all-reduce backward (Megatron's f), the
  conjugate of ``psum``.  It goes where a replicated tensor enters a
  sharded region, so the partial gradients of the ranks' shards add up.
- ``ppermute``: each rank sends to the next rank on the axis and receives
  from the previous one, cyclically; the backward sends the gradient the
  other way.
- ``all_gather``: the shards concatenated along a dimension; the backward
  reduce-scatters (sums over the ranks, keeps this rank's slice).
- ``reduce_scatter``: the sum over the ranks, of which each keeps its
  slice; the backward all-gathers.

Every rank must issue the same collectives in the same order, forward and
backward: the port's parallel modules build graphs of one structure on
every rank (data-dependent choices are ``torch.where`` on tensors, as in
JAX, not Python branches on the rank).  On a mesh without a process group
each of these is the identity.  Within a process group every one of them
but ``ppermute`` issues its collective even over a one-rank axis (a copy);
``ppermute`` over one rank sends to itself, so it is the identity.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from mmtrl_tpu_torch.parallel.mesh import Axes, Mesh


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group(axes))
    return y


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: Axes, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: Axes, dim: int) -> torch.Tensor:
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by {n} ranks")
    parts = [p.contiguous() for p in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.group(axis))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axes), None, None


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead on ``axis``, receive from the
    rank ``step`` behind (cyclically)."""
    group, n, me = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.mesh, ctx.axis, -1), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Sum over the ranks of ``axes``; identity backward."""
    return _Psum.apply(x, mesh, axes) if mesh.distributed else x


def enter(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Identity; the backward sums the gradient over the ranks of ``axes``."""
    return _Enter.apply(x, mesh, axes) if mesh.distributed else x


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Rank i's ``x`` goes to rank i + 1 (mod n) on ``axis``."""
    if not mesh.distributed or mesh.size(axis) == 1:
        return x
    return _Ppermute.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order."""
    return _AllGather.apply(x, mesh, axis, dim) if mesh.distributed else x


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: Axes, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over the ranks' ``x``."""
    return _ReduceScatter.apply(x, mesh, axis, dim) if mesh.distributed else x


@torch.no_grad()
def all_reduce_list(tensors: List[torch.Tensor], mesh: Mesh, axes: Axes) -> List[torch.Tensor]:
    """Sums a list of tensors of one dtype over ``axes`` in one all-reduce
    of their concatenation (outside autograd); returns new tensors."""
    if not mesh.distributed or not tensors:
        return list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("all_reduce_list takes tensors of one dtype")
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh, axes)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

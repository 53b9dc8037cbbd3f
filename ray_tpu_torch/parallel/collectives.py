"""The port's explicit collectives over a mesh's process groups.

Where the reference lets XLA insert collectives from sharding annotations
(and ``ppermute``/``psum`` inside ``shard_map``), the port calls them
itself, on local tensors. Every function takes the group from
``Mesh.group``; None (a group of one rank) makes it a no-op that returns
its input. The differentiable ones are ``torch.autograd.Function``s with the
collective's adjoint as their backward:

- ``all_gather`` (gather along a dimension; backward: reduce-scatter);
- ``copy_to`` (identity; backward: all-reduce) and ``reduce_from``
  (all-reduce; backward: identity), Megatron's f and g;
- ``all_to_all`` (variable splits along dimension 0; backward: the
  reverse all-to-all).

``shift`` moves tensors one hop around a group's ring by point-to-point
send and receive (the ring attention's and GPipe's transport).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# torch 2.13 renames these two; the card's torch has the old names
_all_gather_op = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_op = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, not differentiable."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_op(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter_op(out, src, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in group-rank
    order; the gradient is summed over the group and scattered back."""
    if group is None:
        return x
    return _AllGather.apply(x, dim, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Enter a region where each rank holds part of a product: identity
    forward, gradient summed over the group."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Leave such a region: the partial results summed over the group
    forward, the gradient passed through."""
    return x if group is None else _ReduceFrom.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, grad):
        out_splits, in_splits = ctx.splits
        return _all_to_all(grad, in_splits, out_splits, ctx.group), None, None, None


def _all_to_all(x, out_splits, in_splits, group):
    x = x.contiguous()
    out = torch.empty((sum(out_splits),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, list(out_splits), list(in_splits), group=group)
    return out


def all_to_all(
    x: torch.Tensor, out_splits: Sequence[int], in_splits: Sequence[int], group: Group
) -> torch.Tensor:
    """Rows ``x[sum(in_splits[:j]):][:in_splits[j]]`` go to group rank j;
    the result holds ``out_splits[i]`` rows from each rank i, in rank
    order. Differentiable."""
    if group is None:
        return x
    return _AllToAll.apply(x, tuple(out_splits), tuple(in_splits), group)


class Shift:
    """Tensors in flight one hop around a group's ring: sent to the next
    group rank, received from the previous one. ``wait()`` returns the
    received tensors."""

    def __init__(self, tensors: Sequence[torch.Tensor], group: Group):
        self._sent = [t.contiguous() for t in tensors]
        if group is None:
            self._received, self._works = self._sent, []
            return
        n, r = dist.get_world_size(group), dist.get_rank(group)
        nxt = dist.get_global_rank(group, (r + 1) % n)
        prv = dist.get_global_rank(group, (r - 1) % n)
        self._received = [torch.empty_like(t) for t in self._sent]
        ops = [dist.P2POp(dist.isend, t, nxt, group, tag) for tag, t in enumerate(self._sent)]
        ops += [dist.P2POp(dist.irecv, t, prv, group, tag) for tag, t in enumerate(self._received)]
        self._works = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        return self._received


def shift(tensors: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """One hop around the ring, waited for."""
    return Shift(tensors, group).wait()


def broadcast_(x: torch.Tensor, src_rank: int, group: Group) -> torch.Tensor:
    """In place, from group rank ``src_rank``."""
    if group is not None:
        dist.broadcast(x, dist.get_global_rank(group, src_rank), group=group)
    return x

"""Collectives over one process group, for the sharded render and train steps.

Four operations, each along dim 0 and each summing where it reduces:
``all_gather`` (differentiable: its backward is ``reduce_scatter``, the
transpose JAX gives ``lax.all_gather``), ``reduce_scatter``, ``all_reduce_``
and its asynchronous form ``all_reduce_async_``. NCCL runs them on the card
and gloo on the host; gloo also takes CUDA tensors for all of them (torch
2.11 on an H100), which is how two ranks share one card, where NCCL refuses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, split along dim 0 -> this rank's part
    ([x.shape[0] / group size, ...]; dim 0 must divide)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not divide by {size}")
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group, in place -> ``x``."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_async_(x: torch.Tensor, group):
    """Start summing ``x`` over the group, in place -> the collective's
    ``dist.Work``, or None when the group has one rank (nothing to do).

    ``x`` must not be read or written until ``work.wait()`` has returned: on
    NCCL ``wait`` makes the CURRENT stream wait for the collective, so call it
    on the stream that reads ``x`` next; on gloo it blocks the host until
    the sum is in ``x`` (and, for a CUDA tensor, orders the current stream
    after the copy back)."""
    if dist.get_world_size(group) == 1:
        return None
    return dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group, async_op=True)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size = dist.get_world_size(group)
        if size == 1:
            return x.clone()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent of the gathered tensor holds a part for this
        # rank's rows: they are summed, not sliced (a slice would drop the
        # other ranks' contributions to this rank's rows)
        return reduce_scatter(g, ctx.group), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in group-rank order ->
    [group size * x.shape[0], ...]. Differentiable: the backward sums the
    cotangents over the group and gives each rank its own rows
    (``reduce_scatter``)."""
    return _AllGather.apply(x, group)

"""Differentiable collectives over one mesh axis: what GSPMD inserts for the
JAX package's shardings, written out for the port's parallel training.

Each is a ``torch.autograd.Function`` over a process group (a mesh axis'
``axis_group``); the backward is the forward's transpose:

    copy_to          identity          | all-reduce     (Megatron's f)
    reduce_from      all-reduce        | identity       (Megatron's g)
    gather_from      all-gather        | local slice
    split_to         local slice       | all-gather
    all_gather       all-gather        | reduce-scatter (FSDP, SP entry)
    reduce_scatter   reduce-scatter    | all-gather     (SP exit)
    broadcast        from one rank     | the source's gradient, 0 elsewhere
    shift            to the next rank  | to the previous rank (pipeline)

``copy_to`` / ``reduce_from`` / ``gather_from`` assume that what follows is
computed alike on every rank of the group (its gradient arrives whole on
each), as the replicated loss makes it. With ``group`` None (no mesh)
each is the identity. The list forms of all-gather and
reduce-scatter are used because NCCL and gloo both take them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(size(group), dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim)[rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.is_src = dist.get_rank() == src
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


def _send_recv(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank + step and return what rank - step sent (zeros
    where that rank is outside the group): a chain, no wrap-around."""
    n, r = size(group), rank(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, r + step), group))
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, r - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1), None


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, dim, group):
    return x if group is None else _GatherFrom.apply(x, dim, group)


def split_to(x, dim, group):
    return x if group is None else _SplitTo.apply(x, dim, group)


def all_gather(x, dim, group):
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x, dim, group):
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def broadcast(x, src: int, group):
    """``x`` of the global rank ``src`` on every rank of ``group``."""
    return _Broadcast.apply(x, src, group)


def shift(x, group):
    """Each rank's ``x`` to the next rank of ``group``; rank 0 gets zeros.
    The gradient travels back one rank."""
    return _Shift.apply(x, group)

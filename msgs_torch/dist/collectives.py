"""Collectives over a mesh axis, the counterparts of `jax.lax.all_to_all`,
`all_gather` and `psum` inside shard_map.

`all_to_all` and `all_gather` are torch.autograd.Functions with the
transposes JAX's autodiff gives them: the backward of an all-to-all is an
all-to-all of the gradients over the same group; the backward of an
all-gather leaves each rank the sum, over the group, of the gradients of
its own slice. `psum` and the state movers (`gather`, `broadcast`) do not
differentiate. They sit directly on torch.distributed's collectives
(torch.distributed.nn.functional is not used: its all-gather and
all-to-all address subgroups by global rank).

On an axis whose `staged` flag is set (gloo with CUDA tensors, mesh.Axis),
every collective copies its tensor to the host, runs there and copies the
result back; `axis.stats["host_bytes"]` counts both copies. Booleans travel
as uint8.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

def _to_wire(x: torch.Tensor, axis) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if axis.staged:
        axis.stats["host_bytes"] += x.numel() * x.element_size()
        x = x.cpu()
    return x


def _from_wire(w: torch.Tensor, like: torch.Tensor, axis) -> torch.Tensor:
    if axis.staged:
        axis.stats["host_bytes"] += w.numel() * w.element_size()
        w = w.to(like.device)
    return w.to(like.dtype) if w.dtype != like.dtype else w


def all_to_all_raw(x: torch.Tensor, axis) -> torch.Tensor:
    """Tiled all-to-all over dim 0 (split_axis = concat_axis = 0): block i
    of x goes to the axis's rank i; block j of the result came from rank j.
    dim 0 must be a multiple of axis.size."""
    w = _to_wire(x, axis)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=axis.group)
    return _from_wire(out, x, axis)


def gather(x: torch.Tensor, axis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's x, in axis order. No gradient."""
    w = _to_wire(x, axis)
    out = torch.empty((axis.size,) + tuple(w.shape), dtype=w.dtype,
                      device=w.device)
    dist.all_gather_into_tensor(out, w[None], group=axis.group)
    return _from_wire(out, x, axis)


def _own_wire(x: torch.Tensor, axis) -> torch.Tensor:
    """x on the wire, in storage of its own (an in-place collective must
    not write into x)."""
    w = _to_wire(x.detach(), axis)
    return w.clone() if w.data_ptr() == x.data_ptr() else w


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of x over the axis, on every rank of it. No gradient."""
    w = _own_wire(x, axis)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=axis.group)
    return _from_wire(w, x, axis)


def broadcast(x: torch.Tensor, axis, src: int = 0) -> torch.Tensor:
    """Rank `src` of the axis's x, on every rank of it. No gradient."""
    w = _own_wire(x, axis)
    dist.broadcast(w, group=axis.group,
                   src=dist.get_global_rank(axis.group, src)
                   if axis.group is not dist.group.WORLD else src)
    return _from_wire(w, x, axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_to_all_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        # Each rank's slice was read by every rank: its gradient is the
        # sum over the group of that slice's cotangents.
        return psum(g, ctx.axis)[ctx.axis.index], None


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """Differentiable tiled all-to-all (jax.lax.all_to_all with
    split_axis=0, concat_axis=0, tiled=True)."""
    return _AllToAll.apply(x, axis)


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """Differentiable all-gather, stacked on a new leading axis
    (jax.lax.all_gather with axis=0)."""
    return _AllGather.apply(x, axis)

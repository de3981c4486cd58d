"""Differentiable collectives of the tensor-parallel block MLP and attention
(Megatron's f and g): the forward and backward of each are a pair of
identity / all-reduce or slice / all-gather over the "model" group. They
reduce in f32 whatever the activation dtype (gloo has no bf16 sums on
every build, and the partial sums are f32 accumulations anyway), and
return the input's dtype."""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    out = x.float().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-split layer is used by every shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The forward sums the row-split layer's partial outputs over the
    group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceToModel(torch.autograd.Function):
    """This rank's slice of `dim` (of `n` elements from `start`); the
    backward gathers every rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, start, n, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None, None, None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's slices of `dim`, in rank order; the backward keeps this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.n
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def slice_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal share of `dim` (its rank in the group picks it)."""
    n = x.shape[dim] // dist.get_world_size(group)
    return _SliceToModel.apply(x, dim, dist.get_rank(group) * n, n, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, group)

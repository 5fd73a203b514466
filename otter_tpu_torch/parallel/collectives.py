"""Differentiable collectives over one process group (the port's own: the
JAX package leaves these to GSPMD).

Every tensor outside a sharded region is replicated across the group, and
so is its gradient. The four functions keep that true through autograd:

  - `copy_to(x)`: identity; the backward sums the partial gradients that
    the ranks' local products left (Megatron's f).
  - `reduce_from(x)`: sums partial results across the group; the
    backward passes the replicated gradient through (Megatron's g).
  - `split(x, dim)`: this rank's slice of a replicated tensor; the
    backward gathers the slices' gradients into the whole.
  - `gather(x, dim)`: the ranks' slices concatenated in rank order; the
    backward keeps this rank's slice of the gradient.

With a group of one rank each is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, out of place (not differentiable)."""
    if _size(group) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """x's elementwise max over the group, out of place."""
    if _size(group) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along `dim` in rank order
    (not differentiable)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)[_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return local_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)

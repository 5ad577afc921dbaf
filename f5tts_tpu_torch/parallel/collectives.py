"""The collectives of tensor and data parallelism over `torch.distributed`.

The JAX package has no counterpart: GSPMD inserts these where a sharded
array needs them. Here they are explicit:
- `copy_to_tp`: identity forward, all-reduce of the gradient backward, at
  the input of a column-parallel projection (each rank's heads or FF
  columns contribute to the input's gradient);
- `reduce_from_tp`: all-reduce forward, identity backward, after a
  row-parallel product (the reference's RowLinear all-reduce, JAX's psum);
  partial products are summed in f32 and cast back once;
- `all_reduce_flat`, `reduce_scatter_flat`, `all_gather_flat` and
  `all_reduce_max`: data-parallel gradients, ZeRO-1 shards, int8 row scales.
Every collective runs over the group it is given and never picks a backend:
the process group's backend is the caller's (NCCL on the card, gloo only
where the caller asked for it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class TP(NamedTuple):
    """A tensor-parallel group as the backbones take it: the process group,
    its size and this rank's index in it (`parallel.mesh.Mesh.tp`)."""

    group: object
    size: int
    rank: int


# torch 2.13 renames the flat collectives; older releases have only the
# first names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: x all-reduced (sum) over `group` in f32, in x's dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """x as it is; its gradient all-reduced over `tp.group` (the input of
    this rank's column-parallel projections)."""
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum over `tp.group` of each rank's partial x (f32, cast back);
    its gradient passes through as it is."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp.group)
    return _sum_f32(x, tp.group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the elementwise max of x over `group`."""
    y = x.clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of x over `group`."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_reduce_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum the 1-D buffer `flat` over `group`, in place."""
    dist.all_reduce(flat, group=group)
    return flat


def reduce_scatter_flat(flat: torch.Tensor, shard: int, group) -> torch.Tensor:
    """This rank's `shard` elements of the sum of `flat` (length group size
    x shard) over `group`."""
    out = torch.empty(shard, dtype=flat.dtype, device=flat.device)
    _reduce_scatter(out, flat, group=group)
    return out


def all_gather_flat(out: torch.Tensor, shard: torch.Tensor, group) -> torch.Tensor:
    """Fill the 1-D `out` with every rank's `shard`, rank order."""
    _all_gather(out, shard.contiguous(), group=group)
    return out


def all_gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, rank order."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)

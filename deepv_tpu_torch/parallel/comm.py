"""The collectives of the mesh paths, as plain functions over a process group.

deepv_tpu is one program over all chips: GSPMD inserts the MMDiT's
reductions and ``shard_map`` code calls ``psum``, ``all_gather`` and
``ppermute``. The port runs one process per rank, every rank the same code
on its own shard, and these functions stand in for those collectives. They
use only ``all_reduce`` and ``all_gather``: the gloo backend cannot send or
receive CUDA tensors, and NCCL refuses two ranks on one card, so a one-card
machine can run the mesh path only as gloo ranks sharing the card, which
rules out point-to-point calls. The neighbour exchange that ``ppermute``
does is therefore an ``all_gather`` of each rank's edge rows.

``all_reduce`` and ``all_gather`` act outside autograd: inference calls
them under ``inference_mode``. The tensor-parallel forward that training
differentiates goes through two ``torch.autograd.Function``s instead, the
pair of Megatron's split (deepv_tpu's GSPMD derives the same reductions
from the shardings):

  - ``reduce``: the sum over the group in the forward, the identity in the
    backward (each rank's partial product gets the whole cotangent of the
    replicated sum); row-split outputs go through it;
  - ``copy``: the identity in the forward, the sum of the cotangent over
    the group in the backward (each rank's slice of a split computation
    contributes a part of a replicated input's gradient); the input of every
    column-split linear, and every replicated parameter that a rank applies
    to its own heads only, go through it.

``counts`` and ``nbytes`` record, per collective, the calls since the last
``reset_counts()`` and the bytes this rank handed in; a backward's
reductions count as ``all_reduce`` calls like the forward's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

counts = {"all_reduce": 0, "all_gather": 0}
nbytes = {"all_reduce": 0, "all_gather": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    for d in (counts, nbytes):
        for k in d:
            d[k] = 0


def _count(name: str, x: torch.Tensor) -> None:
    counts[name] += 1
    nbytes[name] += x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (or max) of ``x`` over the ranks of ``group``,
    in x's dtype. Reduces x in place when it is contiguous, else a
    contiguous copy; returns the result. Every rank gets the same bits."""
    x = x.contiguous()
    _count("all_reduce", x)
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    ranks' shapes must agree)."""
    x = x.contiguous()
    _count("all_gather", x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # a copy: an autograd function must not modify its input in place
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``all_reduce``), with the identity as
    its backward. Where autograd does not record (inference), it is
    ``all_reduce`` itself, in place, with the same bits."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, group)
    return all_reduce(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself in the forward; in the backward, its cotangent summed
    over ``group``. No communication where autograd does not record."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Copy.apply(x, group)
    return x


def halo(x: torch.Tensor, dim: int, group, before: int, after: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neighbours' edge rows of a tensor split along ``dim`` in rank
    order: (the previous rank's last ``before`` rows, the next rank's first
    ``after`` rows), zeros at the ends of the group (the zero padding of the
    whole tensor). One ``all_gather`` of each rank's edge rows."""
    n, r, length = dist.get_world_size(group), dist.get_rank(group), x.shape[dim]
    if length < max(before, after):
        raise ValueError(f"a halo of {max(before, after)} rows needs as many local rows, "
                         f"got {length}")
    edges = torch.cat([x.narrow(dim, 0, after), x.narrow(dim, length - before, before)], dim=dim)
    parts = all_gather(edges, dim, group).split(after + before, dim=dim)
    lo = (parts[r - 1].narrow(dim, after, before) if r > 0
          else x.new_zeros(x.shape[:dim] + (before,) + x.shape[dim + 1:]))
    hi = (parts[r + 1].narrow(dim, 0, after) if r < n - 1
          else x.new_zeros(x.shape[:dim] + (after,) + x.shape[dim + 1:]))
    return lo, hi

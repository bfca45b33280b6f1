"""Collectives of the port's multi-device paths, each with the backward that
JAX's SPMD gives its counterpart.

The JAX package runs one program over a mesh and XLA inserts the
collectives. The port runs one process per rank under
``torch.distributed``, and its code calls these functions on one *group*:
a ``torch.distributed`` process group (NCCL on the card, gloo on the CPU,
or gloo on the card for ranks that share one device), or ``None`` for a
rank alone, where every function here is the identity and no process group
need exist. So the same code runs in one process and in many.

Two kinds of sum, which differ only in the backward:

- :func:`psum_replicated`, for a sum whose output every rank of the group
  then uses *the same way*: the ranks of a point-sharded (``points``) axis
  each hold a slab of the cloud, sum their partial gathers, and compute the
  identical rest of the step from the sum. Their losses are one loss, not a
  sum of losses, so the cotangent of the sum is already the whole cotangent
  on every rank and the backward passes it through. (JAX: ``psum``, whose
  transpose on an invariant output is ``pbroadcast``.)
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangents
  instead, which on these ranks gives a gradient ``size(group)`` times too
  large.
- :func:`psum_varying`, for a sum whose output feeds computations that
  differ from rank to rank: batch norm's statistics over the data-parallel
  (``data``) axis, where each rank normalises its own rows and computes its
  own share of the loss. Every rank's share depends on the sum, so the
  cotangent of the sum is the sum of the ranks' cotangents, and the backward
  all-reduces them. (JAX: the invariant sum enters varying code through a
  ``pbroadcast``, whose transpose is ``psum``.)

:func:`all_gather` is exact for any value: it sums zero-filled slots of the
values' integer bit patterns, so each slot's bits arrive unchanged (a float
``-0.0`` or a NaN payload too). It runs on every backend alike, the gloo on
the card included, and has no gradient: every caller gathers indices,
distances or picks.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# same-width integer views: summing a slot's bits with zeros leaves them exact
_BITS = {4: torch.int32, 8: torch.int64}


def size(group: Group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def index(group: Group) -> int:
    """This process's rank within ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of ``x`` over the group's
    ranks, as a new tensor (for None, ``x`` itself, detached). No
    gradient."""
    if group is None:
        return x.detach()
    out = x.detach().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_reduce_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Sum each tensor over the group in place, in one collective (over a
    flat buffer where there are several: the gradient sum of a data-parallel
    step; a single contiguous tensor is summed where it lies)."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], group=group)
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _PSumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PSumVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def psum_replicated(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group; the backward passes the cotangent through (the
    output is used alike on every rank: see the module docstring)."""
    return x if group is None else _PSumReplicated.apply(x, group)


def psum_varying(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group; the backward sums the cotangents over the group
    (each rank uses the output in its own way: see the module docstring)."""
    return x if group is None else _PSumVarying.apply(x, group)


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: (size, *x.shape), bit for
    bit. No gradient."""
    x = x.detach().contiguous()
    if group is None:
        return x[None]
    n, r = size(group), index(group)
    slots = torch.zeros((n,) + tuple(x.shape), dtype=_BITS[x.element_size()], device=x.device)
    slots[r] = x.view(slots.dtype)
    dist.all_reduce(slots, group=group)
    return slots.view(x.dtype)


def broadcast_object(obj: Any, group: Group, src: int = 0) -> Any:
    """``obj`` of the group's rank ``src`` on every rank (pickled; a tree of
    numpy arrays arrives bit for bit)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group)
    return box[0]

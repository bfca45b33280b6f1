"""Ball query and grouped gather (port of votenet_tpu/ops/grouping.py).

Selection semantics, the same as the JAX package's "exact" mode (see its
module docstring, the authoritative statement): a point is a hit iff
``d2 < r2`` strictly on difference-form f32 distances, with
``r2 = float32(radius) * float32(radius)`` squared in f32; the output takes
the first ``nsample`` hits in index order; slots past the last hit repeat the
first hit; an empty ball is index 0; counts saturate at ``nsample``.

``group_point`` is differentiable with respect to its points: its backward is
the scatter-add of ``csrc/scatter.cu`` for a CUDA tensor, the plain version
for a CPU tensor (``scatter_add``).
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.ballquery import (
    finalize_first_k,
    query_ball_point_cuda,
    query_ball_point_plain,
)
from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

__all__ = ["query_ball_point", "finalize_first_k", "group_point", "scatter_add"]


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Fixed-radius neighbourhood query.

    xyz1: (B, N, 3) points, xyz2: (B, M, 3) queries -> idx (B, M, nsample)
    int32 and cnt (B, M) int32. A CPU tensor runs the plain version, a CUDA
    tensor the kernel of ``csrc/ballquery.cu``. The inputs are detached: the
    query has no gradient (the proposal layer queries votes, which do).
    """
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if kernel_route(xyz1, "query_ball_point") == "cuda":
        return query_ball_point_cuda(radius, nsample, xyz1.contiguous(), xyz2.contiguous())
    return query_ball_point_plain(radius, nsample, xyz1, xyz2)


def scatter_add(g: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """group_point backward: g (B, K, C) or (B, M, S, C), idx (B, K) or
    (B, M, S) -> (B, num_rows, C) f32, ``out[b, n] = sum of g[b, k] over
    idx[b, k] == n`` in ascending k. A CPU tensor runs the plain version, a
    CUDA tensor the kernel of ``csrc/scatter.cu``; any other device raises."""
    B, C = g.shape[0], g.shape[-1]
    g = g.reshape(B, -1, C)
    idx = idx.reshape(B, -1)
    if kernel_route(g, "scatter_add") == "cuda":
        return scatter_add_cuda(g.float().contiguous(), idx.to(torch.int32).contiguous(), num_rows)
    return scatter_add_plain(g, idx, num_rows)


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, N, C = points.shape
    _, M, S = idx.shape
    off = (torch.arange(B, device=idx.device) * N)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    return points.reshape(B * N, C).index_select(0, flat).reshape(B, M, S, C)


class _GroupPoint(torch.autograd.Function):
    """The gather, with the scatter-add as its backward (the JAX package's
    ``_group_point_tpu``, ``votenet_tpu/ops/grouping.py:390-416``)."""

    @staticmethod
    def forward(ctx, points, idx, grad_skip_prefix):
        ctx.save_for_backward(idx)
        ctx.num_rows = points.shape[1]
        ctx.skip = grad_skip_prefix
        return _gather(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        skip = ctx.skip
        d = scatter_add(grad[..., skip:].contiguous(), idx, ctx.num_rows)
        if skip:
            zeros = torch.zeros(d.shape[:2] + (skip,), dtype=d.dtype, device=d.device)
            d = torch.cat([zeros, d], dim=-1)
        return d.to(grad.dtype), None, None


def group_point(points: torch.Tensor, idx: torch.Tensor, grad_skip_prefix: int = 0) -> torch.Tensor:
    """Gather grouped features: (B, N, C), (B, M, S) -> (B, M, S, C).

    Differentiable with respect to ``points``; the backward scatters the
    cotangent with :func:`scatter_add`. ``grad_skip_prefix=k`` declares the
    cotangent of channels [:k] dead (returned as zeros): pass k > 0 only when
    those channels carry no gradient, as the SA layers' detached coordinates
    do. The scatter then runs at the feature width (128/256, not 131/259).
    """
    return _GroupPoint.apply(points, idx, grad_skip_prefix)

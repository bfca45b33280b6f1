"""Ball query and grouped gather (port of votenet_tpu/ops/grouping.py).

Selection semantics, the same as the JAX package's "exact" mode (see its
module docstring, the authoritative statement): a point is a hit iff
``d2 < r2`` strictly on difference-form f32 distances, with
``r2 = float32(radius) * float32(radius)`` squared in f32; the output takes
the first ``nsample`` hits in index order; slots past the last hit repeat the
first hit; an empty ball is index 0; counts saturate at ``nsample``.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.ballquery import (
    finalize_first_k,
    query_ball_point_cuda,
    query_ball_point_plain,
)

__all__ = ["query_ball_point", "finalize_first_k", "group_point"]


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


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather grouped features: (B, N, C), (B, M, S) -> (B, M, S, C).

    Forward only: the backward scatter (the JAX package's fourth Pallas
    kernel) comes with training.
    """
    B, N, C = points.shape
    _, M, S = idx.shape
    off = (torch.arange(B, device=idx.device) * N)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    return points.reshape(B * N, C).index_select(0, flat).reshape(B, M, S, C)

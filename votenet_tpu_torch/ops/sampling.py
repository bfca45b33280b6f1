"""Farthest-point sampling and point gather (port of votenet_tpu/ops/sampling.py)."""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.fps import (
    farthest_point_sample_cuda,
    farthest_point_sample_plain,
)


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Iterative FPS seeded at index 0: (B, N, 3) -> (B, npoint) int32.

    A CPU tensor runs the plain version, a CUDA tensor the kernel of
    ``csrc/fps.cu``; both give the indices of the JAX package's
    ``farthest_point_sample`` bit for bit. No gradient.
    """
    xyz = xyz.detach().float()
    if kernel_route(xyz, "farthest_point_sample") == "cuda":
        return farthest_point_sample_cuda(npoint, xyz.contiguous())
    return farthest_point_sample_plain(npoint, xyz)


def gather_point(inp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by index: (B, N, C), (B, M) -> (B, M, C)."""
    C = inp.shape[-1]
    return torch.gather(inp, 1, idx.long()[..., None].expand(-1, -1, C))

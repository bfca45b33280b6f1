"""Farthest-point sampling and point gather (port of votenet_tpu/ops/sampling.py)."""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.fps import (
    farthest_point_sample_cuda,
    farthest_point_sample_plain,
    fps_rowwise_noscalar_cuda,
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


def fps_rowwise_noscalar(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """FPS as :func:`farthest_point_sample`, through the noscalar variant
    (the prototype ``benchmarks/fps_noscalar_proto.py:97``): the same
    indices. A CPU tensor runs the plain version, a CUDA tensor the variant
    of ``csrc/fps.cu``; any other device raises. No gradient."""
    xyz = xyz.detach().float()
    if kernel_route(xyz, "fps_rowwise_noscalar") == "cuda":
        return fps_rowwise_noscalar_cuda(npoint, xyz.contiguous())
    return farthest_point_sample_plain(npoint, xyz)


def gather_point(inp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by index: (B, N, C), (B, M) -> (B, M, C)."""
    C = inp.shape[-1]
    return torch.gather(inp, 1, idx.long()[..., None].expand(-1, -1, C))


def prob_sample(inp_p: torch.Tensor, inp_r: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical sampling (the JAX package's ``prob_sample``,
    reference tf_sampling.py:50-57): inp_p (B, N) unnormalised
    probabilities, inp_r (B, M) draws in [0, sum(p)) -> (B, M) int32, the
    first index whose running sum exceeds the draw, clipped to [0, N - 1].
    Plain PyTorch on every device (no path calls it). The running sum is
    ``torch.cumsum`` in the input's dtype, sequential on the CPU: where a
    float sum rounds, another order can move an index by one."""
    cdf = torch.cumsum(inp_p, dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), inp_r.to(cdf.dtype).contiguous(), right=True)
    return torch.clamp(idx, 0, inp_p.shape[-1] - 1).to(torch.int32)

"""Three-nearest-neighbour interpolation (port of votenet_tpu/ops/interpolate.py)."""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import pairwise_sqdist


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The 3 nearest xyz2 points of each xyz1 point.

    xyz1: (B, N, 3) queries, xyz2: (B, M, 3) sources -> (dist2, idx), each
    (B, N, 3): squared distances ascending and int32 indices into M. Three
    argmin passes, each taking the lowest index among equal distances, as
    the JAX package does (not top-k, whose tie order is unspecified).
    No gradient.
    """
    d = pairwise_sqdist(xyz1.detach().float(), xyz2.detach().float())  # (B, N, M)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1, keepdim=True)  # first minimal index
        dists.append(torch.gather(d, -1, i))
        idxs.append(i)
        d = d.scatter(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-neighbour sum: points (B, M, C), idx (B, N, 3), weight
    (B, N, 3) -> (B, N, C), summed in neighbour order ``(w0*p0 + w1*p1) + w2*p2``."""
    B, N, _ = idx.shape
    M, C = points.shape[1], points.shape[2]
    off = (torch.arange(B, device=idx.device) * M)[:, None, None]
    flat = (idx.long() + off).reshape(-1)
    g = points.reshape(B * M, C).index_select(0, flat).reshape(B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]

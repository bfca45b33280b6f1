"""Farthest-point sampling: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/fps.cu``. It replaces the Pallas kernels
``votenet_tpu/ops/pallas/fps.py:47 _fps_kernel`` and ``:79
_fps_rowwise_kernel`` with one CTA per batch row; the running minimum stays
in shared memory up to ``votenet_fps_smem_limit()`` bytes (N = 51200 points)
and in a global scratch buffer beyond. On the H100 it is bound by the latency
of its npoint sequential steps (a pass over N and a block argmax each), not
by bandwidth: see the note at the top of the source.

Semantics of both versions (``votenet_tpu/ops/sampling.py:76-101``
``farthest_point_sample_xla``): slot 0 is index 0; each step picks the argmax
of the running minimum squared distance (initialised to 1e38) with the lowest
index on ties; d2 is ``(dx*dx + dy*dy) + dz*dz`` in f32, never fused.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda


def farthest_point_sample_plain(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) f32 -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)  # (B, N) each
    mindist = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        mindist = torch.minimum(mindist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mindist, dim=-1)  # first maximal index on ties
        idxs[:, i] = last.to(torch.int32)
    return idxs


def farthest_point_sample_cuda(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Launch the FPS kernel: contiguous (B, N, 3) f32 CUDA -> (B, npoint) int32.

    Raises for a tensor that is not on a CUDA device; it never computes the
    plain version. Adds one to ``farthest_point_sample_cuda.launches`` per
    launch.
    """
    require_cuda("farthest_point_sample_cuda", xyz, 3, 3)
    B, N, _ = xyz.shape
    if npoint < 1 or B < 1 or N < 1:
        raise ValueError(f"farthest_point_sample_cuda: need npoint, B, N >= 1, got {npoint}, {B}, {N}")
    lib = library()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    scratch = None
    if N * 4 > lib.votenet_fps_smem_limit():
        scratch = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.votenet_fps(
            xyz.data_ptr(), B, N, npoint, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, "fps")
    farthest_point_sample_cuda.launches += 1
    return out


farthest_point_sample_cuda.launches = 0

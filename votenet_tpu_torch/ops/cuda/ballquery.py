"""Exact ball query: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/ballquery.cu``. It replaces the Pallas
kernel ``votenet_tpu/ops/pallas/ballquery.py:71 _bq_kernel`` with one warp
per query that walks the points in index order 32 at a time and compacts the
hits with a ballot, stopping once ``nsample`` are found. On the H100 it is
bound by the distance tests it reads through L2 (B*M*N at worst); see the
note at the top of the source.

Semantics of both versions (``votenet_tpu/ops/grouping.py:143-251``
``_query_ball_point_dense`` in "exact" mode, then ``finalize_first_k``,
``:536-544``): a point is a hit iff ``d2 < r2`` strictly, with
``d2 = (dx*dx + dy*dy) + dz*dz`` in f32, never fused; idx holds the first
``nsample`` hits in index order, slots past the last hit repeat the first
hit, an empty ball is all 0; cnt is the hit count saturated at ``nsample``.

``r2`` is :func:`radius_sq`: the radius rounded to f32 and squared in f32,
as the JAX XLA twin does (``grouping.py:194``). The JAX Pallas kernel
rounds the double square instead (``ballquery.py:217``), one ulp lower at
radii 0.2, 0.4 and 0.8; the port follows the twin, everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu_torch.ops.common import pairwise_sqdist
from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda

# query rows per chunk of the plain version: bounds its (chunk, N) temporaries
_PLAIN_ROWS = 256


def radius_sq(radius: float) -> float:
    """float32(radius) * float32(radius), rounded in f32 (exact as a Python float)."""
    r = np.float32(radius)
    return float(r * r)


def finalize_first_k(idx: torch.Tensor, cnt: torch.Tensor, nsample: int):
    """Reference padding of a first-k state (``grouping.py:536-544``): slots
    past the last hit repeat the first hit; an empty ball is all index 0."""
    slot = torch.arange(nsample, device=idx.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx, cnt


def _first_k_plain(hit: torch.Tensor, nsample: int):
    """First ``nsample`` set positions of each row of ``hit`` (R, N), in
    order, padded by :func:`finalize_first_k` -> (idx (R, nsample), cnt (R,)).

    The (s+1)-th hit is the first position whose running hit count reaches
    s+1: a search over the row's cumulative count. Exact and deterministic
    (no top-k, whose order among equal keys is unspecified)."""
    R = hit.shape[0]
    cum = torch.cumsum(hit.to(torch.int32), dim=-1, dtype=torch.int32)
    want = torch.arange(1, nsample + 1, dtype=torch.int32, device=hit.device)
    pos = torch.searchsorted(cum, want.expand(R, nsample).contiguous())
    return finalize_first_k(pos.to(torch.int32), torch.clamp(cum[:, -1], max=nsample), nsample)


def query_ball_point_plain(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain PyTorch ball query: points (B, N, 3), queries (B, M, 3) ->
    idx (B, M, nsample) int32, cnt (B, M) int32."""
    xyz1 = xyz1.float()
    xyz2 = xyz2.float()
    B, M = xyz2.shape[0], xyz2.shape[1]
    r2 = radius_sq(radius)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    for b in range(B):
        for m0 in range(0, M, _PLAIN_ROWS):
            hit = pairwise_sqdist(xyz2[b, m0 : m0 + _PLAIN_ROWS], xyz1[b]) < r2
            idx[b, m0 : m0 + _PLAIN_ROWS], cnt[b, m0 : m0 + _PLAIN_ROWS] = _first_k_plain(hit, nsample)
    return idx, cnt


def query_ball_point_cuda(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Launch the ball-query kernel on contiguous f32 CUDA tensors: points
    (B, N, 3), queries (B, M, 3) -> idx (B, M, nsample) int32, cnt (B, M) int32.

    Raises for a tensor that is not on a CUDA device; it never computes the
    plain version. Adds one to ``query_ball_point_cuda.launches`` per launch.
    """
    require_cuda("query_ball_point_cuda", xyz1, 3, 3)
    require_cuda("query_ball_point_cuda", xyz2, 3, 3)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B or xyz2.device != xyz1.device:
        raise ValueError("query_ball_point_cuda: points and queries must share batch and device")
    if nsample < 1 or B < 1 or N < 1 or M < 1:
        raise ValueError(f"query_ball_point_cuda: need nsample, B, N, M >= 1, got {nsample}, {B}, {N}, {M}")
    lib = library()
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        err = lib.votenet_ball_query(
            xyz1.data_ptr(), xyz2.data_ptr(), B, N, M, radius_sq(radius), nsample,
            idx.data_ptr(), cnt.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, "ball_query")
    query_ball_point_cuda.launches += 1
    return idx, cnt


query_ball_point_cuda.launches = 0

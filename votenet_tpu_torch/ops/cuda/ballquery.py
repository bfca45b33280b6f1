"""Exact ball query: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/ballquery.cu``. It replaces the Pallas
kernel ``votenet_tpu/ops/pallas/ballquery.py:71 _bq_kernel`` with one thread
per query: a block of BQ_QUERIES queries of one batch row walks the row's
points in shared-memory tiles of BQ_TILE points, each thread appending its
hits in index order, and leaves once every ball is full. Where the grid
would underfill the card, :func:`ballquery_route` cuts each row's points
into segments, one block per (query block, segment), and a merge pass
concatenates the segments' hits in order. On the H100 it is bound by the
distance tests (B*M*N at worst); see the note at the top of the source.

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

The emit variant (:func:`query_ball_point_emit_xyz_cuda`, after the prototype
``benchmarks/bq_emit_xyz_proto.py:44 _bq_emit_kernel``) also returns the
grouped coordinates gxyz (B, M, nsample, 3) f32, bit-equal to
``group_point(xyz1, idx)``: the kernel copies them from its point tiles as
it appends the hits, or the merge pass copies them by index.

The fast_bf16 variant (``mode="fast_bf16"``, ``Config.bq_precision``) is
the port's own kernel for a mode that reaches no Pallas kernel in the JAX
package: its hit test is ``ops.common.pairwise_sqdist_fast_bf16`` (the TPU
semantics of the JAX XLA twin's matmul expansion, see there) against the
same ``r2``, on the same selection, padding and routes. Its launches count
in ``query_ball_point_cuda.fast_bf16.launches``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from votenet_tpu_torch.ops.common import pairwise_sqdist, pairwise_sqdist_fast_bf16
from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda, sm_count
from votenet_tpu_torch.ops.dispatch import check_bq_mode

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


def query_ball_point_plain(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                           mode: str = "exact"):
    """Plain PyTorch ball query: points (B, N, 3), queries (B, M, 3) ->
    idx (B, M, nsample) int32, cnt (B, M) int32. ``mode`` "fast_bf16" takes
    the hit test of :func:`~votenet_tpu_torch.ops.common.pairwise_sqdist_fast_bf16`."""
    check_bq_mode(mode)
    sqdist = pairwise_sqdist if mode == "exact" else pairwise_sqdist_fast_bf16
    xyz1 = xyz1.float()
    xyz2 = xyz2.float()
    B, M = xyz2.shape[0], xyz2.shape[1]
    r2 = radius_sq(radius)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    for b in range(B):
        for m0 in range(0, M, _PLAIN_ROWS):
            hit = sqdist(xyz2[b, m0 : m0 + _PLAIN_ROWS], xyz1[b]) < r2
            idx[b, m0 : m0 + _PLAIN_ROWS], cnt[b, m0 : m0 + _PLAIN_ROWS] = _first_k_plain(hit, nsample)
    return idx, cnt


# mirror csrc/ballquery.cu: queries (threads) of a block, points of a tile
BQ_QUERIES, BQ_TILE = 128, 256
# The route's rule: split a row's points while the grid has fewer than
# BQ_BLOCKS_PER_SM blocks a streaming multiprocessor (64 warps, all it
# holds), into at most BQ_MAX_SEGMENTS segments of at least one tile
# (chip_smoke.py phase 3 times each main-path shape through the other route
# beside the rule's).
BQ_BLOCKS_PER_SM, BQ_MAX_SEGMENTS = 16, 16


def ballquery_route(B: int, N: int, M: int, sms: int, segments: int | None = None) -> tuple[int, int]:
    """(segments a row's points are cut into, points of a segment) of a
    launch on a card of ``sms`` SMs: one segment where B * ceil(M /
    BQ_QUERIES) blocks fill it; otherwise as many as bring the grid to
    BQ_BLOCKS_PER_SM blocks an SM, at most BQ_MAX_SEGMENTS, each at least a
    tile. Segments are whole tiles, so the count may come out below the one
    asked for. ``segments`` forces the count (before that rounding)."""
    if segments is None:
        blocks = B * -(-M // BQ_QUERIES)
        want = -(-sms * BQ_BLOCKS_PER_SM // blocks)
        segments = max(1, min(want, BQ_MAX_SEGMENTS, N // BQ_TILE))
    seg_pts = -(-(-(-N // segments)) // BQ_TILE) * BQ_TILE
    return -(-N // seg_pts), seg_pts


def _launch(name: str, radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
            segments: int | None, emit: bool, mode: str = "exact"):
    """Check the arguments and launch ``votenet_ball_query``: (idx, cnt),
    and with ``emit`` the grouped coordinates after them."""
    check_bq_mode(mode)
    require_cuda(name, xyz1, 3, 3)
    require_cuda(name, xyz2, 3, 3)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B or xyz2.device != xyz1.device:
        raise ValueError(f"{name}: points and queries must share batch and device")
    if nsample < 1 or B < 1 or N < 1 or M < 1:
        raise ValueError(f"{name}: need nsample, B, N, M >= 1, got {nsample}, {B}, {N}, {M}")
    if segments is not None and segments < 1:
        raise ValueError(f"{name}: segments must be >= 1, got {segments}")
    lib = library()
    nseg, seg_pts = ballquery_route(B, N, M, sm_count(xyz1.device.index), segments)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz1.device)
    gxyz = torch.empty((B, M, nsample, 3), dtype=torch.float32, device=xyz1.device) if emit else None
    seg_idx = seg_cnt = None
    if nseg > 1:
        seg_idx = torch.empty((B, M, nseg, nsample), dtype=torch.int32, device=xyz1.device)
        seg_cnt = torch.empty((B, M, nseg), dtype=torch.int32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        err = lib.votenet_ball_query(
            xyz1.data_ptr(), xyz2.data_ptr(), B, N, M, radius_sq(radius), nsample, nseg, seg_pts,
            int(mode == "fast_bf16"),
            None if seg_idx is None else seg_idx.data_ptr(), None if seg_cnt is None else seg_cnt.data_ptr(),
            idx.data_ptr(), cnt.data_ptr(), None if gxyz is None else gxyz.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, name)
    return (idx, cnt, gxyz) if emit else (idx, cnt)


def query_ball_point_cuda(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                          segments: int | None = None, mode: str = "exact"):
    """Launch the ball-query kernel's ``mode`` variant ("exact" or
    "fast_bf16") on contiguous f32 CUDA tensors: points (B, N, 3), queries
    (B, M, 3) -> idx (B, M, nsample) int32, cnt (B, M) int32.

    ``segments`` forces the route (:func:`ballquery_route`); by default the
    card's SM count picks it. Raises for a tensor that is not on a CUDA
    device; it never computes the plain version. Adds one per call (one or,
    split, two kernels) to ``query_ball_point_cuda.launches`` (exact) or
    ``query_ball_point_cuda.fast_bf16.launches``.
    """
    out = _launch("query_ball_point_cuda", radius, nsample, xyz1, xyz2, segments, emit=False, mode=mode)
    if mode == "exact":
        query_ball_point_cuda.launches += 1
    else:
        query_ball_point_cuda.fast_bf16.launches += 1
    return out


query_ball_point_cuda.launches = 0
query_ball_point_cuda.fast_bf16 = SimpleNamespace(launches=0)  # the fast_bf16 variant's own count


def query_ball_point_emit_xyz_plain(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain version of the emit variant: :func:`query_ball_point_plain`,
    then the gather of the grouped coordinates -> idx (B, M, nsample) int32,
    cnt (B, M) int32, gxyz (B, M, nsample, 3) f32."""
    xyz1 = xyz1.float()
    idx, cnt = query_ball_point_plain(radius, nsample, xyz1, xyz2)
    B, N, _ = xyz1.shape
    flat = (idx.long() + (torch.arange(B, device=idx.device) * N)[:, None, None]).reshape(-1)
    gxyz = xyz1.reshape(B * N, 3).index_select(0, flat).reshape(idx.shape + (3,))
    return idx, cnt, gxyz


def query_ball_point_emit_xyz_cuda(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                                   segments: int | None = None):
    """Launch the ball-query kernel's emit variant on contiguous f32 CUDA
    tensors: points (B, N, 3), queries (B, M, 3) -> idx (B, M, nsample)
    int32, cnt (B, M) int32 and gxyz (B, M, nsample, 3) f32, bit-equal to
    :func:`query_ball_point_cuda` and ``group_point(xyz1, idx)``.

    ``segments`` forces the route, as for :func:`query_ball_point_cuda`.
    Raises for a tensor that is not on a CUDA device; it never computes the
    plain version. Adds one to ``query_ball_point_emit_xyz_cuda.launches``
    per call.
    """
    out = _launch("query_ball_point_emit_xyz_cuda", radius, nsample, xyz1, xyz2, segments, emit=True)
    query_ball_point_emit_xyz_cuda.launches += 1
    return out


query_ball_point_emit_xyz_cuda.launches = 0

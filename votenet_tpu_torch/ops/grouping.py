"""Ball query and grouped gather (port of votenet_tpu/ops/grouping.py).

Selection semantics, the same as the JAX package's "exact" mode (see its
module docstring, the authoritative statement): a point is a hit iff
``d2 < r2`` strictly on difference-form f32 distances, with
``r2 = float32(radius) * float32(radius)`` squared in f32; the output takes
the first ``nsample`` hits in index order; slots past the last hit repeat the
first hit; an empty ball is index 0; counts saturate at ``nsample``. The
"fast_bf16" mode (``ops.dispatch.bq_precision``) changes the hit test only:
``ops.common.pairwise_sqdist_fast_bf16``, the TPU semantics of the JAX
package's matmul expansion, against the same ``r2``.

``group_point`` is differentiable with respect to its points: its backward is
the scatter-add of ``csrc/scatter.cu`` for a CUDA tensor, the plain version
for a CPU tensor (``scatter_add``).
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route, pairwise_sqdist
from votenet_tpu_torch.ops.cuda.ballquery import (
    finalize_first_k,
    query_ball_point_cuda,
    query_ball_point_emit_xyz_cuda,
    query_ball_point_emit_xyz_plain,
    query_ball_point_plain,
    radius_sq,
)
from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain
from votenet_tpu_torch.ops.dispatch import bq_precision

__all__ = ["query_ball_point", "query_ball_point_emit_xyz", "merge_first_k", "finalize_first_k", "group_point",
           "scatter_add", "query_ball_point_topk", "knn_point", "select_top_k"]


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                     mode: str | None = None):
    """Fixed-radius neighbourhood query.

    xyz1: (B, N, 3) points, xyz2: (B, M, 3) queries -> idx (B, M, nsample)
    int32 and cnt (B, M) int32. A CPU tensor runs the plain version, a CUDA
    tensor the kernel of ``csrc/ballquery.cu``. ``mode`` is "exact" or
    "fast_bf16"; None reads ``ops.dispatch.bq_precision()`` at this call.
    The inputs are detached: the query has no gradient (the proposal layer
    queries votes, which do).
    """
    mode = bq_precision() if mode is None else mode
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if kernel_route(xyz1, "query_ball_point") == "cuda":
        return query_ball_point_cuda(radius, nsample, xyz1.contiguous(), xyz2.contiguous(), mode=mode)
    return query_ball_point_plain(radius, nsample, xyz1, xyz2, mode)


def query_ball_point_emit_xyz(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The ball query that also returns the grouped coordinates (the
    prototype ``benchmarks/bq_emit_xyz_proto.py:174``): idx (B, M, nsample)
    int32, cnt (B, M) int32 as :func:`query_ball_point`, and gxyz (B, M,
    nsample, 3) f32 equal to ``group_point(xyz1, idx)``. A CPU tensor runs
    the plain version, a CUDA tensor the emit variant of
    ``csrc/ballquery.cu``; any other device raises. No gradient: the inputs
    are detached, as the prototype stops them."""
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    if kernel_route(xyz1, "query_ball_point_emit_xyz") == "cuda":
        return query_ball_point_emit_xyz_cuda(radius, nsample, xyz1.contiguous(), xyz2.contiguous())
    return query_ball_point_emit_xyz_plain(radius, nsample, xyz1, xyz2)


def merge_first_k(idx_st: torch.Tensor, cnt_st: torch.Tensor, bidx: torch.Tensor, bcnt: torch.Tensor,
                  nsample: int):
    """Merge a partial first-k result into a running (idx, cnt) state
    (``votenet_tpu/ops/grouping.py:518-533``).

    ``(idx_st, cnt_st)`` hold the first ``cnt_st`` hits found so far, in
    index order; ``(bidx, bcnt)`` is a partial result over a later index
    range (every index above those stored: point shards are merged in
    ascending order). Slots of ``bidx`` at or past ``bcnt`` are fill, masked
    off by the counts. Returns the merged (idx, cnt), counts saturated at
    ``nsample``; :func:`finalize_first_k` then pads it."""
    slot = torch.arange(nsample, device=idx_st.device)
    take = torch.minimum(nsample - cnt_st, bcnt)
    shift = torch.clamp(slot - cnt_st[..., None], 0, nsample - 1)
    shifted = torch.gather(bidx, -1, shift.long())
    merged = torch.where(slot < cnt_st[..., None], idx_st, shifted)
    return merged, cnt_st + take


def scatter_add(g: torch.Tensor, idx: torch.Tensor, num_rows: int, mode: str = "exact") -> torch.Tensor:
    """group_point backward: g (B, K, C) or (B, M, S, C), idx (B, K) or
    (B, M, S) -> (B, num_rows, C) f32, ``out[b, n] = sum of g[b, k] over
    idx[b, k] == n`` in ascending k. A CPU tensor runs the plain version, a
    CUDA tensor the kernel of ``csrc/scatter.cu``; any other device raises.

    ``mode`` is the JAX package's ``scatter_precision``
    (``votenet_tpu/ops/grouping.py:373-387``): "exact", or "fast_bf16",
    which rounds each f32 update to bf16 before the f32 sum (the TPU
    kernel's single pass). A bf16 ``g`` is exact in either mode: it is
    widened to f32 and takes the exact route. Either route raises for
    another mode.
    """
    if g.dtype == torch.bfloat16:
        mode = "exact"
    B, C = g.shape[0], g.shape[-1]
    g = g.reshape(B, -1, C)
    idx = idx.reshape(B, -1)
    if kernel_route(g, "scatter_add") == "cuda":
        return scatter_add_cuda(g.float().contiguous(), idx.to(torch.int32).contiguous(), num_rows, mode)
    return scatter_add_plain(g, idx, num_rows, mode)


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
    def forward(ctx, points, idx, grad_skip_prefix, scatter):
        ctx.save_for_backward(idx)
        ctx.num_rows = points.shape[1]
        ctx.skip = grad_skip_prefix
        ctx.scatter = scatter
        return _gather(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        skip = ctx.skip
        d = scatter_add(grad[..., skip:].contiguous(), idx, ctx.num_rows, ctx.scatter)
        if skip:
            zeros = torch.zeros(d.shape[:2] + (skip,), dtype=d.dtype, device=d.device)
            d = torch.cat([zeros, d], dim=-1)
        return d.to(grad.dtype), None, None, None  # the f32 sum, cast to the cotangent's dtype


def group_point(
    points: torch.Tensor, idx: torch.Tensor, grad_skip_prefix: int = 0, scatter: str = "exact"
) -> torch.Tensor:
    """Gather grouped features: (B, N, C), (B, M, S) -> (B, M, S, C), in
    the dtype of ``points``.

    Differentiable with respect to ``points``; the backward scatters the
    cotangent with :func:`scatter_add` in mode ``scatter`` ("exact" or
    "fast_bf16"). ``grad_skip_prefix=k`` declares the cotangent of channels
    [:k] dead (returned as zeros): pass k > 0 only when those channels carry
    no gradient, as the SA layers' detached coordinates do. The scatter then
    runs at the feature width (128/256, not 131/259).
    """
    return _GroupPoint.apply(points, idx, grad_skip_prefix, scatter)


# The reference API's other grouping ops (``votenet_tpu/ops/grouping.py:59,
# 548, 561``). No model path calls them and none reaches a Pallas kernel in
# the JAX package: plain PyTorch on every device, no gradient.


def query_ball_point_topk(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The readable oracle of the ball query (the JAX package's
    ``query_ball_point_topk``): hits by the exact difference form against
    ``radius_sq(radius)``, the ``nsample`` smallest of the keys "index if a
    hit, else N", then the reference padding. Same results as
    :func:`query_ball_point` in "exact" mode. nsample <= N."""
    xyz1 = xyz1.detach().float()
    xyz2 = xyz2.detach().float()
    N = xyz1.shape[1]
    hit = pairwise_sqdist(xyz2, xyz1) < radius_sq(radius)  # (B, M, N), strict
    iota = torch.arange(N, dtype=torch.int32, device=xyz1.device)
    key = torch.where(hit, iota, torch.full_like(iota, N))
    idx_sorted = torch.sort(key, dim=-1).values[..., :nsample]  # the first hits, sentinel-padded
    idx = torch.where(idx_sorted >= N, idx_sorted[..., :1], idx_sorted)
    idx = torch.where(idx >= N, torch.zeros_like(idx), idx)  # an empty ball -> 0
    cnt = torch.clamp(hit.sum(dim=-1), max=nsample).to(torch.int32)
    return idx, cnt


def select_top_k(k: int, dist: torch.Tensor):
    """Sort each row of ``dist`` (B, M, N) ascending (the reference's
    partial selection sort, tf_grouping.py:22-31; the JAX package returns the
    full stable sort, a refinement, and so does this) -> (idx (B, M, N)
    int32, the sorted distances). Equal distances keep index order. ``k`` is
    the reference's and orders nothing more than the full sort does."""
    del k
    order = torch.sort(dist, dim=-1, stable=True).indices
    return order.to(torch.int32), torch.gather(dist, -1, order)


def knn_point(k: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """k nearest points by exact squared distance: xyz1 (B, N, 3) points,
    xyz2 (B, M, 3) queries -> (dist2, idx), each (B, M, k), ascending.

    ``lax.top_k`` (the JAX package's) puts the lower index first among equal
    distances; ``torch.topk`` promises no order there, so this takes the
    first k of a stable ascending sort, which does."""
    d2 = pairwise_sqdist(xyz2.detach().float(), xyz1.detach().float())  # (B, M, N)
    vals, order = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], order[..., :k].to(torch.int32)

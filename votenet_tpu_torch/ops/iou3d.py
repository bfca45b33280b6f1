"""Exact oriented 3D box IoU (port of votenet_tpu/ops/iou3d.py).

Box corner layout (the decode's): corners 0-3 are the top face (+h/2), 4-7
the bottom face; the top-face polygon is corners[:4] in (x, z) and the y
extent runs from corners[4].y to corners[0].y.

The production formulation is edge-clip (:func:`box3d_iou_matrix`): each
edge of one quad clipped to the other's half-planes, the shoelace integral
summed over the clipped segments. Every reduction in it is written out as
adds in a stated order, ``((t0 + t1) + t2) + t3`` over a quad's edges, and
every product and difference is a separate rounding, so that the CPU, the
card's eager ops and the kernel of ``csrc/iou3d.cu`` (which
:func:`box3d_iou_matrix` runs for a CUDA tensor) compute the same floats:
an NMS keep mask must not depend on the device. The operations are the
JAX package's (``votenet_tpu/ops/iou3d.py:146-217, 329-347``); only its
``jnp.sum`` reductions, whose order XLA chooses, are fixed here.

The JAX package's three other formulations, kept there as independent
cross-checks of edge-clip, are ported as plain PyTorch on every device:
:func:`convex_quad_intersection_area` (rank-based angular order),
:func:`convex_quad_intersection_area_sh` (Sutherland-Hodgman) and
:func:`convex_quad_intersection_area_sort` (the reference's atan2 sort).
"""

from __future__ import annotations

import math

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda

_EPS = 1e-12
# pairs of one block of the plain matrix. A pair holds ~700 B of (4, 4)
# intermediates at once. The CPU (the CPU route of ops.nms3d) runs
# cache-sized blocks: at B=8, N=256 they took 265-443 ms against one
# block's 491-763 on an H100 host's 8 threads (two runs). Another device
# runs blocks only past ~1 GiB of intermediates: one block there took
# 2.47-2.48 ms on the H100 against 13.9-15.8 in blocks of 65536
# (chip_smoke.py phase 26, both).
_PLAIN_BLOCK_PAIRS = 1 << 16
_PLAIN_DEVICE_BLOCK_PAIRS = 1 << 20


def _sum4(t: torch.Tensor) -> torch.Tensor:
    """``((t0 + t1) + t2) + t3`` over the last dimension (size 4)."""
    return ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]


def quad_signed_area(quad: torch.Tensor) -> torch.Tensor:
    """Shoelace signed area of a quad, (..., 4, 2) -> (...,):
    ``0.5 * (((t0 + t1) + t2) + t3)``, ``t_k = x_k * z_k+1 - x_k+1 * z_k``."""
    x, z = quad[..., 0], quad[..., 1]
    xn, zn = torch.roll(x, -1, dims=-1), torch.roll(z, -1, dims=-1)
    return 0.5 * _sum4(x * zn - xn * z)


def _boundary_contrib(A: torch.Tensor, B: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """Sum of cross(x0, x1) over A's edges clipped to the inside of B
    (s_b = B's orientation sign; segments keep A's traversal order), the
    edges added in order 0-3."""
    d = torch.roll(A, -1, dims=-2) - A  # edge directions
    q = B[..., None, :, :]  # (..., 1, 4, 2) clip-plane anchors
    e = (torch.roll(B, -1, dims=-2) - B)[..., None, :, :]
    am = A[..., :, None, :] - q  # (..., 4A, 4B, 2)
    # inside(t): s_b * cross(e, x(t) - q) = c0 + t*c1 >= 0
    sb = s_b[..., None, None]
    c0 = sb * (e[..., 0] * am[..., 1] - e[..., 1] * am[..., 0])
    c1 = sb * (e[..., 0] * d[..., :, None, 1] - e[..., 1] * d[..., :, None, 0])
    pos = c1 > _EPS
    neg = c1 < -_EPS
    t_at = -c0 / torch.where(pos | neg, c1, torch.ones_like(c1))
    lo = torch.amax(torch.where(pos, t_at, torch.zeros_like(t_at)), dim=-1)
    hi = torch.amin(torch.where(neg, t_at, torch.ones_like(t_at)), dim=-1)
    # an edge parallel to a plane with its start strictly outside is clipped away
    dead = torch.any(~pos & ~neg & (c0 < -_EPS), dim=-1)
    lo = torch.clamp(lo, 0.0, 1.0)
    hi = torch.clamp(hi, 0.0, 1.0)
    valid = (hi > lo) & ~dead
    x0 = A + lo[..., None] * d
    x1 = A + hi[..., None] * d
    cr = x0[..., 0] * x1[..., 1] - x1[..., 0] * x0[..., 1]
    return _sum4(torch.where(valid, cr, torch.zeros_like(cr)))


def convex_quad_intersection_area_edgeclip(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of two convex quads, (..., 4, 2) -> (...,).

    Each edge of one quad is clipped against the other's four half-planes by
    interval arithmetic, and the shoelace integral is summed over the clipped
    directed segments (JAX ``iou3d.py:146-217``, where the derivation is):
    ``0.5 * (sp * b_P + sq * b_Q)`` clamped to ``[0, min(|area P|, |area
    Q|)]``.
    """
    P, Q = torch.broadcast_tensors(P, Q)
    aP, aQ = quad_signed_area(P), quad_signed_area(Q)
    sp, sq = torch.sign(aP), torch.sign(aQ)
    area = 0.5 * (sp * _boundary_contrib(P, Q, sq) + sq * _boundary_contrib(Q, P, sp))
    cap = torch.minimum(torch.abs(aP), torch.abs(aQ))
    return torch.minimum(torch.clamp(area, min=0.0), cap)


def _top_quad(c: torch.Tensor) -> torch.Tensor:
    return torch.stack([c[..., :4, 0], c[..., :4, 2]], dim=-1)


def box3d_iou_pairwise(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Elementwise 3D IoU of aligned box arrays: (..., 8, 3) x2 -> (...,).
    Plain PyTorch on every device; :func:`box3d_iou_matrix` is the one
    with a kernel."""
    quad1, quad2 = _top_quad(c1), _top_quad(c2)
    inter_area = convex_quad_intersection_area_edgeclip(quad1, quad2)
    y1t, y1b = c1[..., 0, 1], c1[..., 4, 1]
    y2t, y2b = c2[..., 0, 1], c2[..., 4, 1]
    y_overlap = torch.clamp(torch.minimum(y1t, y2t) - torch.maximum(y1b, y2b), min=0.0)
    inter_vol = inter_area * y_overlap
    vol1 = torch.abs(quad_signed_area(quad1)) * (y1t - y1b)
    vol2 = torch.abs(quad_signed_area(quad2)) * (y2t - y2b)
    denom = (vol1 + vol2) - inter_vol
    ok = denom > _EPS
    return torch.where(ok, inter_vol / torch.where(ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))


def box3d_iou_matrix_plain(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: :func:`box3d_iou_pairwise` of every
    (row, column) pair, (..., N, 8, 3), (..., M, 8, 3) -> (..., N, M), in
    blocks of rows of at most ``_PLAIN_BLOCK_PAIRS`` pairs on the CPU and
    ``_PLAIN_DEVICE_BLOCK_PAIRS`` elsewhere (every pair is computed alone,
    so the blocks change no float)."""
    lead = torch.broadcast_shapes(c1.shape[:-3], c2.shape[:-3])
    c1 = c1.expand(*lead, *c1.shape[-3:])
    c2 = c2.expand(*lead, *c2.shape[-3:])
    N, M = c1.shape[-3], c2.shape[-3]
    block = _PLAIN_BLOCK_PAIRS if c1.device.type == "cpu" else _PLAIN_DEVICE_BLOCK_PAIRS
    rows = max(1, block // max(1, M * math.prod(lead)))
    out = [box3d_iou_pairwise(c1[..., r0:r0 + rows, None, :, :], c2[..., None, :, :, :])
           for r0 in range(0, N, rows)]
    return torch.cat(out, dim=-2) if out else c1.new_zeros((*lead, 0, M))


def box3d_iou_matrix(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Full pairwise IoU matrix: (..., N, 8, 3), (..., M, 8, 3) -> (..., N, M)
    f32. A CPU tensor runs :func:`box3d_iou_matrix_plain`, a CUDA tensor the
    kernel of ``csrc/iou3d.cu`` (equal floats; ``c1 is c2`` computes one
    triangle of the symmetric matrix); any other device raises."""
    if kernel_route(c1, "box3d_iou_matrix") == "cuda":
        lead = torch.broadcast_shapes(c1.shape[:-3], c2.shape[:-3])
        N, M = c1.shape[-3], c2.shape[-3]
        a = c1.float().expand(*lead, N, 8, 3).reshape(-1, N, 8, 3).contiguous()
        b = a if c2 is c1 else c2.float().expand(*lead, M, 8, 3).reshape(-1, M, 8, 3).contiguous()
        return box3d_iou_matrix_cuda(a, b).reshape(*lead, N, M)
    return box3d_iou_matrix_plain(c1.float(), c2.float())


# ------------------------------------------------ the cross-check formulations
# (JAX ``iou3d.py:30-143, 223-326``; plain PyTorch, no kernel, on no path)


def _cross2(o: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2D cross product (a - o) x (b - o), broadcast over leading dims."""
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2) inside the convex quad (..., 4, 2) -> (..., P) bool,
    boundary inclusive, either orientation."""
    sign = torch.sign(quad_signed_area(quad))[..., None, None]
    a = quad[..., None, :, :]
    b = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    cr = _cross2(a, b, pts[..., :, None, :])  # (..., P, 4)
    return torch.all(sign * cr >= -_EPS, dim=-1)


def _edge_intersections(P: torch.Tensor, Q: torch.Tensor):
    """The 16 edge-pair intersections of two quads: (points (..., 16, 2),
    valid (..., 16))."""
    a1 = P[..., :, None, :]
    a2 = torch.roll(P, -1, dims=-2)[..., :, None, :]
    b1 = Q[..., None, :, :]
    b2 = torch.roll(Q, -1, dims=-2)[..., None, :, :]
    da, db = a2 - a1, b2 - b1
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]  # (..., 4, 4)
    safe = torch.where(torch.abs(denom) < _EPS, torch.ones_like(denom), denom)
    dab = b1 - a1
    t = (dab[..., 0] * db[..., 1] - dab[..., 1] * db[..., 0]) / safe
    u = (dab[..., 0] * da[..., 1] - dab[..., 1] * da[..., 0]) / safe
    valid = (torch.abs(denom) >= _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pt = a1 + t[..., None] * da  # (..., 4, 4, 2)
    return pt.reshape(*pt.shape[:-3], 16, 2), valid.reshape(*valid.shape[:-2], 16)


def _candidates(P: torch.Tensor, Q: torch.Tensor):
    """The intersection polygon's candidate vertices (P's corners inside Q,
    Q's inside P, the edge crossings): (pts (..., 24, 2), valid, count,
    angle about the valid candidates' centroid, +inf where invalid)."""
    inter_pts, inter_valid = _edge_intersections(P, Q)
    pts = torch.cat([P, Q, inter_pts], dim=-2)
    valid = torch.cat([_points_in_quad(P, Q), _points_in_quad(Q, P), inter_valid], dim=-1)
    cnt = valid.sum(dim=-1)
    centroid = (pts * valid[..., None].to(pts.dtype)).sum(dim=-2) / torch.clamp(cnt, min=1)[..., None].to(pts.dtype)
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    return pts, valid, cnt, torch.where(valid, ang, torch.full_like(ang, float("inf")))


def convex_quad_intersection_area(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Intersection area by the candidate vertices ordered by angular rank
    (a 24 x 24 comparison, no sort) and the cyclic shoelace as a rank-
    adjacency sum (JAX ``iou3d.py:87``), (..., 4, 2) -> (...,)."""
    P, Q = torch.broadcast_tensors(P, Q)
    pts, valid, cnt, ang = _candidates(P, Q)
    idx = torch.arange(ang.shape[-1], device=ang.device)
    a_j, a_i = ang[..., :, None], ang[..., None, :]
    before = (a_j < a_i) | ((a_j == a_i) & (idx[:, None] < idx[None, :]))
    both = valid[..., :, None] & valid[..., None, :]
    rank = (before & both).sum(dim=-2)  # valid candidates strictly before i
    nxt = torch.where(rank + 1 >= cnt[..., None], torch.zeros_like(rank), rank + 1)
    adj = both & (rank[..., None, :] == nxt[..., :, None])  # j directly follows i
    cross = pts[..., :, None, 0] * pts[..., None, :, 1] - pts[..., None, :, 0] * pts[..., :, None, 1]
    total = torch.where(adj, cross, torch.zeros_like(cross)).sum(dim=(-1, -2))
    return torch.where(cnt >= 3, 0.5 * torch.abs(total), torch.zeros_like(total))


_SH_CAP = 12  # vertices through the 4 clip stages (the final polygon has at most 8)


def convex_quad_intersection_area_sh(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Sutherland-Hodgman: P clipped by Q's four half-planes in a vertex
    buffer of fixed capacity with one-hot compaction (JAX ``iou3d.py:223``),
    (..., 4, 2) -> (...,)."""
    P, Q = torch.broadcast_tensors(P.float(), Q.float())
    ccw = quad_signed_area(Q) >= 0  # the clip polygon made counter-clockwise
    Q = torch.where(ccw[..., None, None], Q, torch.flip(Q, dims=[-2]))
    V = _SH_CAP
    batch = P.shape[:-2]
    pts = torch.cat([P, P.new_zeros(*batch, V - 4, 2)], dim=-2)
    cnt = torch.full(batch, 4, dtype=torch.int64, device=P.device)
    slot = torch.arange(V, device=P.device).expand(*batch, V)
    out_slot = slot[..., None, :]
    for k in range(4):
        a, b = Q[..., k, :], Q[..., (k + 1) % 4, :]
        ex, ez = (b - a)[..., 0:1], (b - a)[..., 1:2]
        nxt = torch.where(slot + 1 >= cnt[..., None], torch.zeros_like(slot), slot + 1)
        q = torch.gather(pts, -2, nxt[..., None].expand(*nxt.shape, 2))
        live = slot < cnt[..., None]
        side_p = ex * (pts[..., 1] - a[..., 1:2]) - ez * (pts[..., 0] - a[..., 0:1]) >= 0
        side_q = ex * (q[..., 1] - a[..., 1:2]) - ez * (q[..., 0] - a[..., 0:1]) >= 0
        emit_v = live & side_p
        emit_x = live & (side_p != side_q)
        d = q - pts
        denom = ex * d[..., 1] - ez * d[..., 0]
        safe = torch.where(torch.abs(denom) < _EPS, torch.ones_like(denom), denom)
        t = (ex * (a[..., 1:2] - pts[..., 1]) - ez * (a[..., 0:1] - pts[..., 0])) / safe
        x = pts + t[..., None] * d
        counts = emit_v.long() + emit_x.long()
        offs = torch.cumsum(counts, dim=-1) - counts  # exclusive
        pos_x = offs + emit_v.long()
        new_cnt = offs[..., -1] + counts[..., -1]
        oh_v = (emit_v[..., None] & (offs[..., None] == out_slot)).float()  # (..., V_in, V_out)
        oh_x = (emit_x[..., None] & (pos_x[..., None] == out_slot)).float()
        pts = torch.einsum("...ik,...id->...kd", oh_v, pts) + torch.einsum("...ik,...id->...kd", oh_x, x)
        cnt = new_cnt
    nxt = torch.where(slot + 1 >= cnt[..., None], torch.zeros_like(slot), slot + 1)
    q = torch.gather(pts, -2, nxt[..., None].expand(*nxt.shape, 2))
    live = (slot < cnt[..., None]).float()
    cross = pts[..., 0] * q[..., 1] - q[..., 0] * pts[..., 1]
    area = 0.5 * torch.abs((cross * live).sum(dim=-1))
    return torch.where(cnt >= 3, area, torch.zeros_like(area))


def convex_quad_intersection_area_sort(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """The reference's method (tf_nms3d.cpp:122-175, JAX ``iou3d.py:293``):
    candidate vertices sorted by angle about their centroid, then the
    shoelace, (..., 4, 2) -> (...,)."""
    P, Q = torch.broadcast_tensors(P, Q)
    pts, valid, cnt, ang = _candidates(P, Q)
    order = torch.argsort(ang, dim=-1, stable=True)
    srt = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    in_cycle = torch.arange(ang.shape[-1], device=ang.device) < cnt[..., None]
    cyc = torch.where(in_cycle[..., None], srt, srt[..., :1, :])
    x, z = cyc[..., 0], cyc[..., 1]
    area = 0.5 * torch.abs((x * torch.roll(z, -1, dims=-1) - torch.roll(x, -1, dims=-1) * z).sum(dim=-1))
    return torch.where(cnt >= 3, area, torch.zeros_like(area))

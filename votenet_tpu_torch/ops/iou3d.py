"""Exact oriented 3D box IoU (port of votenet_tpu/ops/iou3d.py, edge-clip form).

Box corner layout (the decode's): corners 0-3 are the top face (+h/2), 4-7
the bottom face; the top-face polygon is corners[:4] in (x, z) and the y
extent runs from corners[4].y to corners[0].y. The rank, Sutherland-Hodgman
and sort formulations of the JAX package are cross-checks of this one and
are not ported.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quad_signed_area(quad: torch.Tensor) -> torch.Tensor:
    """Shoelace signed area of a quad, (..., 4, 2) -> (...,)."""
    x, z = quad[..., 0], quad[..., 1]
    xn, zn = torch.roll(x, -1, dims=-1), torch.roll(z, -1, dims=-1)
    return 0.5 * torch.sum(x * zn - xn * z, dim=-1)


def _boundary_contrib(A: torch.Tensor, B: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """Sum of cross(x0, x1) over A's edges clipped to the inside of B
    (s_b = B's orientation sign; segments keep A's traversal order)."""
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
    return torch.sum(torch.where(valid, cr, torch.zeros_like(cr)), dim=-1)


def convex_quad_intersection_area_edgeclip(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of two convex quads, (..., 4, 2) -> (...,).

    Each edge of one quad is clipped against the other's four half-planes by
    interval arithmetic, and the shoelace integral is summed over the clipped
    directed segments (JAX ``iou3d.py:146-217``, where the derivation is).
    """
    P, Q = torch.broadcast_tensors(P, Q)
    sp = torch.sign(quad_signed_area(P))
    sq = torch.sign(quad_signed_area(Q))
    area = 0.5 * (sp * _boundary_contrib(P, Q, sq) + sq * _boundary_contrib(Q, P, sp))
    cap = torch.minimum(torch.abs(quad_signed_area(P)), torch.abs(quad_signed_area(Q)))
    return torch.minimum(torch.clamp(area, min=0.0), cap)


def box3d_iou_pairwise(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Elementwise 3D IoU of aligned box arrays: (..., 8, 3) x2 -> (...,)."""
    quad1 = torch.stack([c1[..., :4, 0], c1[..., :4, 2]], dim=-1)
    quad2 = torch.stack([c2[..., :4, 0], c2[..., :4, 2]], dim=-1)
    inter_area = convex_quad_intersection_area_edgeclip(quad1, quad2)
    y1t, y1b = c1[..., 0, 1], c1[..., 4, 1]
    y2t, y2b = c2[..., 0, 1], c2[..., 4, 1]
    y_overlap = torch.clamp(torch.minimum(y1t, y2t) - torch.maximum(y1b, y2b), min=0.0)
    inter_vol = inter_area * y_overlap
    vol1 = torch.abs(quad_signed_area(quad1)) * (y1t - y1b)
    vol2 = torch.abs(quad_signed_area(quad2)) * (y2t - y2b)
    denom = vol1 + vol2 - inter_vol
    ok = denom > _EPS
    return torch.where(ok, inter_vol / torch.where(ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))


def box3d_iou_matrix(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Full pairwise IoU matrix: (..., N, 8, 3), (..., M, 8, 3) -> (..., N, M)."""
    return box3d_iou_pairwise(c1[..., :, None, :, :], c2[..., None, :, :, :])

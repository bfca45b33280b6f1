"""The plain head: proposal channels -> oriented boxes, class scores and the
NMS keep mask, in float64.

Decode as the reference's ``parse_output_to_bboxes`` with VoteNet-TPU's
residual conventions: centre = proposal + delta; heading = (class * 2 +
residual) * pi / NH, taken mod 2 pi; size = mean size of the size class *
max(1 + residual, 1e-6); class = argmax of the semantic logits, its logit
the score. NMS: candidates are the proposals whose objectness logit 1 beats
logit 0; in order of score descending (index ascending among ties), a
candidate is kept unless a kept candidate before it overlaps it by an
oriented 3D IoU above the threshold. The IoU is the edge-clip formulation
of the box's top face in (x, z) times the y overlap (a frozen copy of the
port's plain formulation, ``votenet_tpu_torch/ops/iou3d.py``), run here in
float64.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# SUN RGB-D's 10 classes, their mean sizes (l, w, h) in metres, in class order
CLASSES = ("bed", "table", "sofa", "chair", "toilet", "desk", "dresser", "night_stand", "bookshelf", "bathtub")
MEAN_SIZE = (
    (2.114256, 1.620300, 0.927272), (0.791118, 1.279516, 0.718182), (0.923508, 1.867419, 0.845495),
    (0.591958, 0.552978, 0.827272), (0.699104, 0.454178, 0.756250), (0.695190, 1.346299, 0.736364),
    (0.528526, 1.002642, 1.172878), (0.500618, 0.632163, 0.683424), (0.404671, 1.071108, 1.688889),
    (0.765840, 1.398258, 0.472728),
)
_EPS = 1e-12
# corner k's signs of (l, h, w) / 2 on (x, y, z): corners 0-3 the top face
_SIGNS = ((1, 1, -1, -1, 1, 1, -1, -1), (1, 1, 1, 1, -1, -1, -1, -1), (1, -1, -1, 1, 1, -1, -1, 1))


def corners(size: torch.Tensor, heading: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """(..., 3) sizes (l, w, h: x, z, y extents), (...,) headings, (..., 3)
    centres -> (..., 8, 3) corners, rotated about y."""
    s, c = torch.sin(heading)[..., None], torch.cos(heading)[..., None]
    signs = size.new_tensor(_SIGNS)
    half = 0.5 * size
    x, y, z = half[..., 0:1] * signs[0], half[..., 2:3] * signs[1], half[..., 1:2] * signs[2]
    return torch.stack([c * x + s * z + centre[..., 0:1], y + centre[..., 1:2], c * z - s * x + centre[..., 2:3]],
                       dim=-1)


def decode(ep: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    NH, NS, NC = cfg["num_heading_bin"], cfg["num_size_cluster"], cfg["num_class"]
    out = ep["proposals_output"].double()
    B, P = out.shape[:2]
    scls = torch.argmax(out[..., 5 + 2 * NH:5 + 2 * NH + NS], dim=-1)
    sres = torch.gather(out[..., 5 + 2 * NH + NS:5 + 2 * NH + 4 * NS].reshape(B, P, NS, 3), 2,
                        scls[..., None, None].expand(B, P, 1, 3))[..., 0, :]
    size = out.new_tensor(MEAN_SIZE)[scls] * torch.clamp(1.0 + sres, min=1e-6)
    centre = ep["proposals_xyz"].double() + out[..., 2:5]
    hcls = torch.argmax(out[..., 5:5 + NH], dim=-1)
    hres = torch.gather(out[..., 5 + NH:5 + 2 * NH], 2, hcls[..., None])[..., 0]
    heading = torch.remainder((hcls.double() * 2 + hres) * (math.pi / NH), 2 * math.pi)
    scores = out[..., -NC:]
    best = torch.amax(scores, dim=-1)
    return {"bboxes": corners(size, heading, centre), "class_scores": scores, "class": torch.argmax(scores, -1),
            "score": best, "candidate": out[..., 1] > out[..., 0]}


def _sum4(t):
    return ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]


def _area(quad):
    x, z = quad[..., 0], quad[..., 1]
    return 0.5 * _sum4(x * torch.roll(z, -1, -1) - torch.roll(x, -1, -1) * z)


def _clipped(A, B, s_b):
    d = torch.roll(A, -1, dims=-2) - A
    q = B[..., None, :, :]
    e = (torch.roll(B, -1, dims=-2) - B)[..., None, :, :]
    am = A[..., :, None, :] - q
    sb = s_b[..., None, None]
    c0 = sb * (e[..., 0] * am[..., 1] - e[..., 1] * am[..., 0])
    c1 = sb * (e[..., 0] * d[..., :, None, 1] - e[..., 1] * d[..., :, None, 0])
    pos, neg = c1 > _EPS, c1 < -_EPS
    t_at = -c0 / torch.where(pos | neg, c1, torch.ones_like(c1))
    lo = torch.clamp(torch.amax(torch.where(pos, t_at, torch.zeros_like(t_at)), dim=-1), 0.0, 1.0)
    hi = torch.clamp(torch.amin(torch.where(neg, t_at, torch.ones_like(t_at)), dim=-1), 0.0, 1.0)
    dead = torch.any(~pos & ~neg & (c0 < -_EPS), dim=-1)
    x0, x1 = A + lo[..., None] * d, A + hi[..., None] * d
    cr = x0[..., 0] * x1[..., 1] - x1[..., 0] * x0[..., 1]
    return _sum4(torch.where((hi > lo) & ~dead, cr, torch.zeros_like(cr)))


def iou_matrix(c: torch.Tensor) -> torch.Tensor:
    """(P, 8, 3) corners -> (P, P) oriented 3D IoU."""
    quad = torch.stack([c[:, :4, 0], c[:, :4, 2]], dim=-1)
    Pq, Qq = torch.broadcast_tensors(quad[:, None], quad[None, :])
    aP, aQ = _area(Pq), _area(Qq)
    sp, sq = torch.sign(aP), torch.sign(aQ)
    inter = 0.5 * (sp * _clipped(Pq, Qq, sq) + sq * _clipped(Qq, Pq, sp))
    inter = torch.minimum(torch.clamp(inter, min=0.0), torch.minimum(aP.abs(), aQ.abs()))
    top, bot = c[:, 0, 1], c[:, 4, 1]
    yo = torch.clamp(torch.minimum(top[:, None], top[None, :]) - torch.maximum(bot[:, None], bot[None, :]), min=0.0)
    vol = _area(quad).abs() * (top - bot)
    iv = inter * yo
    return iv / torch.clamp((vol[:, None] + vol[None, :]) - iv, min=_EPS)


def nms_keep(bboxes: torch.Tensor, score: torch.Tensor, candidate: torch.Tensor, thr: float) -> torch.Tensor:
    """(B, P) keep mask of the greedy, as a Jacobi fixpoint over each scene."""
    keep = torch.zeros_like(candidate)
    for b in range(bboxes.shape[0]):
        order = torch.argsort(score[b], descending=True, stable=True)
        P = order.shape[0]
        rank = torch.empty_like(order)
        rank[order] = torch.arange(P, device=order.device)
        supp = (rank[:, None] < rank[None, :]) & (iou_matrix(bboxes[b]) > thr) & candidate[b][:, None]
        kept = candidate[b]
        while True:
            new = candidate[b] & ~torch.any(kept[:, None] & supp, dim=0)
            if torch.equal(new, kept):
                break
            kept = new
        keep[b] = kept
    return keep


def predict(ep: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """Decode and NMS: every proposal's corners, scores, class and the keep
    mask, capped at ``max_detections`` a scene by score."""
    d = decode(ep, cfg)
    keep = nms_keep(d["bboxes"], d["score"], d["candidate"], cfg["nms_iou"])
    if cfg["max_detections"] < keep.shape[-1]:
        s = torch.where(keep, d["score"], torch.full_like(d["score"], -math.inf))
        rank = torch.argsort(torch.argsort(s, dim=-1, descending=True, stable=True), dim=-1, stable=True)
        keep = keep & (rank < cfg["max_detections"])
    d["keep"] = keep
    return d

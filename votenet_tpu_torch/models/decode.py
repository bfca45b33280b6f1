"""Inference decode: proposal head channels -> oriented 3D boxes + NMS
(port of votenet_tpu/models/decode.py). Fixed-shape output: corners, class
scores and a keep mask."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from votenet_tpu.config import Config
from votenet_tpu.data.geometry import CLASS_MEAN_SIZE
from votenet_tpu_torch.ops import nms3d


def get_3d_bbox(box_size: torch.Tensor, heading_angle: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Corners of boxes: box_size (..., 3) as l, w, h (x, z, y extents),
    heading (...,), center (..., 3) -> (..., 8, 3); corners 0-3 are the top
    face (+h/2), 4-7 the bottom."""
    c, s = torch.cos(heading_angle), torch.sin(heading_angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1).reshape(
        heading_angle.shape + (3, 3)
    )
    l, w, h = box_size[..., 0], box_size[..., 1], box_size[..., 2]
    x = torch.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], -1)
    y = torch.stack([h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2], -1)
    z = torch.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], -1)
    corners = torch.stack([x, y, z], dim=-2)  # (..., 3, 8)
    rotated = torch.einsum("...kl,...lm->...mk", R, corners)  # (..., 8, 3)
    return rotated + center[..., None, :]


def decode_proposals(end_points: Dict[str, torch.Tensor], config: Config) -> Dict[str, torch.Tensor]:
    """Head channels -> boxes, class scores and the NMS inputs."""
    NH, NS, NC = config.num_heading_bin, config.num_size_cluster, config.num_class
    out = end_points["proposals_output"]  # (B, P, num_proposal_channels)
    proposals_xyz = end_points["proposals_xyz"]
    B, P = out.shape[0], out.shape[1]

    size_cls = torch.argmax(out[..., 5 + 2 * NH : 5 + 2 * NH + NS], dim=-1)  # (B, P)
    size_res_all = out[..., 5 + 2 * NH + NS : 5 + 2 * NH + 4 * NS].reshape(B, P, NS, 3)
    size_res = torch.gather(size_res_all, 2, size_cls[..., None, None].expand(B, P, 1, 3))[..., 0, :]
    mean_size = torch.as_tensor(CLASS_MEAN_SIZE, device=out.device)[size_cls]  # (B, P, 3)
    # the 1e-6 floor guards tiny or negative sizes
    size_pred = mean_size * torch.clamp(1.0 + size_res, min=1e-6)

    center_pred = proposals_xyz + out[..., 2:5]

    heading_cls = torch.argmax(out[..., 5 : 5 + NH], dim=-1)
    heading_res = torch.gather(out[..., 5 + NH : 5 + 2 * NH], 2, heading_cls[..., None])[..., 0]
    # torch.remainder rounds differently from jnp.mod; within the float tolerance
    heading_pred = torch.remainder(
        (heading_cls.to(torch.float32) * 2 + heading_res) * (math.pi / NH), 2 * math.pi
    )

    corners = get_3d_bbox(size_pred, heading_pred, center_pred)  # (B, P, 8, 3)
    class_scores = out[..., -NC:]
    return {
        "bboxes": corners,
        "class_scores": class_scores,
        "objectness": out[..., :2],
        "nms_scores": torch.amax(class_scores, dim=-1),
        "center_pred": center_pred,
        "size_pred": size_pred,
        "heading_pred": heading_pred,
        "size_cls": size_cls.to(torch.int32),
        "heading_cls": heading_cls.to(torch.int32),
    }


def predict_boxes(end_points: Dict[str, torch.Tensor], config: Config, nms_iou: Optional[float] = None):
    """Decode + NMS -> the decode dict plus ``keep`` (B, P) bool, capped at
    ``config.max_detections`` survivors per scene (highest scores first)."""
    decoded = decode_proposals(end_points, config)
    iou = config.nms_iou if nms_iou is None else nms_iou
    keep = nms3d(decoded["bboxes"], decoded["nms_scores"], decoded["objectness"], iou)
    if config.max_detections < keep.shape[-1]:
        score = torch.where(keep, decoded["nms_scores"], torch.full_like(decoded["nms_scores"], -math.inf))
        order = torch.argsort(score, dim=-1, descending=True, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        keep = keep & (rank < config.max_detections)
    decoded["keep"] = keep
    return decoded

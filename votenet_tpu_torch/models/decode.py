"""Inference decode: proposal head channels -> oriented 3D boxes + NMS
(port of votenet_tpu/models/decode.py). Fixed-shape output: corners, class
scores and a keep mask.

On a CUDA tensor the head is three launches: the decode kernel
(``csrc/decode.cu``), the IoU kernel and the NMS greedy. Its floats and
bits do not depend on the device: the decode's plain version writes every
operation in the kernel's order, with sin and cos written out
(:func:`sincos_plain`) where ``torch.sin``/``torch.cos`` round otherwise on
the card and the CPU."""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from votenet_tpu_torch.config import Config
from votenet_tpu_torch.data.geometry import CLASS_MEAN_SIZE
from votenet_tpu_torch.ops import nms3d
from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.decode import decode_proposals_cuda, heading_scale


@functools.lru_cache(maxsize=None)
def class_mean_size(device: torch.device) -> torch.Tensor:
    """``CLASS_MEAN_SIZE`` (NC, 3) on ``device``, copied there once: a copy
    from the host at every decode would make the host wait for the forward
    (a blocking host-to-device copy syncs the stream)."""
    with torch.inference_mode(False):
        return torch.as_tensor(CLASS_MEAN_SIZE, device=device)


# The stated sin and cos of csrc/decode.cu (sincos_stated), as f32 constants:
# pi/2 in four Cody-Waite parts (the first three of at most 11 significant
# bits, so k * part is exact for |k| < 2^12), f32(2/pi), and Cephes'
# sinf/cosf minimax coefficients on [-pi/4, pi/4].
PIO2_PARTS = tuple(float.fromhex(h) for h in ("0x1.92p+0", "0x1.fb4p-12", "0x1.444p-24", "0x1.68c234p-39"))
TWO_OVER_PI = float.fromhex("0x1.45f306p-1")
SIN_COEFFS = tuple(float.fromhex(h) for h in ("-0x1.9943f2p-13", "0x1.11073cp-7", "-0x1.555546p-3"))
COS_COEFFS = tuple(float.fromhex(h) for h in ("0x1.99eb9cp-16", "-0x1.6c0c34p-10", "0x1.55554ap-5"))
TWO_PI = float.fromhex("0x1.921fb6p+2")  # f32(2 pi)
MIN_SCALE = float.fromhex("0x1.0c6f7ap-20")  # f32(1e-6)
# corner k's signs of (l, h, w) / 2 on (x, y, z): corners 0-3 the top face
CORNER_SIGNS = ((1, 1, -1, -1, 1, 1, -1, -1), (1, 1, 1, 1, -1, -1, -1, -1), (1, -1, -1, 1, 1, -1, -1, 1))


def sincos_plain(x: torch.Tensor):
    """(sin x, cos x) of an f32 tensor, each operation one rounding in the
    kernel's order: k = rint(x * f32(2/pi)), r = x - k pi/2 in four parts,
    the Horner polynomials in r^2, the pair swapped and negated by k's
    quadrant. Within 1.49 ulps of float64 on [0, 2 pi]
    (``tests/test_torch_decode.py``); equal on every device."""
    k = torch.round(x * TWO_OVER_PI)
    r = x
    for part in PIO2_PARTS:
        r = r - k * part
    z = r * r
    s = r + ((z * SIN_COEFFS[0] + SIN_COEFFS[1]) * z + SIN_COEFFS[2]) * z * r
    c = (((z * COS_COEFFS[0] + COS_COEFFS[1]) * z + COS_COEFFS[2]) * z * z - z * 0.5) + 1.0
    quad = k.to(torch.int32) & 3
    swap = (quad & 1) != 0
    a, b = torch.where(swap, c, s), torch.where(swap, s, c)
    return torch.where((quad & 2) != 0, -a, a), torch.where(((quad + 1) & 2) != 0, -b, b)


def get_3d_bbox(box_size: torch.Tensor, heading_angle: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Corners of boxes: box_size (..., 3) as l, w, h (x, z, y extents),
    heading (...,), center (..., 3) -> (..., 8, 3); corners 0-3 are the top
    face (+h/2), 4-7 the bottom. The rotation about y written out as
    ``x' = (c x + s z) + cx``, ``y' = y + cy``, ``z' = (c z - s x) + cz``
    with the stated sin and cos: the kernel's floats."""
    s, c = sincos_plain(heading_angle)
    c, s = c[..., None], s[..., None]
    signs = box_size.new_tensor(CORNER_SIGNS)  # (3, 8), exact
    half = 0.5 * box_size
    x, y, z = half[..., 0:1] * signs[0], half[..., 2:3] * signs[1], half[..., 1:2] * signs[2]
    return torch.stack([(c * x + s * z) + center[..., 0:1], y + center[..., 1:2],
                        (c * z - s * x) + center[..., 2:3]], dim=-1)


def decode_proposals_plain(end_points: Dict[str, torch.Tensor], config: Config) -> Dict[str, torch.Tensor]:
    """The decode kernel's plain version: head channels -> boxes, class
    scores and the NMS inputs, every float operation a separate PyTorch op
    in the kernel's order (``csrc/decode.cu``), so that the CPU and the card
    compute the same floats."""
    NH, NS, NC = config.num_heading_bin, config.num_size_cluster, config.num_class
    out = end_points["proposals_output"].float()  # (B, P, num_proposal_channels)
    B, P = out.shape[0], out.shape[1]

    size_cls = torch.argmax(out[..., 5 + 2 * NH : 5 + 2 * NH + NS], dim=-1)  # (B, P)
    size_res_all = out[..., 5 + 2 * NH + NS : 5 + 2 * NH + 4 * NS].reshape(B, P, NS, 3)
    size_res = torch.gather(size_res_all, 2, size_cls[..., None, None].expand(B, P, 1, 3))[..., 0, :]
    mean_size = class_mean_size(out.device)[size_cls]  # (B, P, 3)
    # the 1e-6 floor guards tiny or negative sizes
    size_pred = mean_size * torch.clamp(1.0 + size_res, min=MIN_SCALE)

    center_pred = end_points["proposals_xyz"].float() + out[..., 2:5]

    heading_cls = torch.argmax(out[..., 5 : 5 + NH], dim=-1)
    heading_res = torch.gather(out[..., 5 + NH : 5 + 2 * NH], 2, heading_cls[..., None])[..., 0]
    # jnp.mod's formulation: fmod (exact on every device), then + 2 pi where negative
    angle = (heading_cls.to(torch.float32) * 2 + heading_res) * heading_scale(NH)
    heading_pred = torch.fmod(angle, TWO_PI)
    heading_pred = torch.where(heading_pred < 0, heading_pred + TWO_PI, heading_pred)

    class_scores = out[..., -NC:]
    # the maximum logit, the first of equal ones: the same float (and zero's sign) on every device
    nms_scores = torch.gather(class_scores, -1, torch.argmax(class_scores, dim=-1, keepdim=True))[..., 0]
    return {
        "bboxes": get_3d_bbox(size_pred, heading_pred, center_pred),
        "class_scores": class_scores,
        "objectness": out[..., :2],
        "nms_scores": nms_scores,
        "center_pred": center_pred,
        "size_pred": size_pred,
        "heading_pred": heading_pred,
        "size_cls": size_cls.to(torch.int32),
        "heading_cls": heading_cls.to(torch.int32),
    }


def decode_proposals(end_points: Dict[str, torch.Tensor], config: Config) -> Dict[str, torch.Tensor]:
    """Head channels -> boxes, class scores and the NMS inputs. A CUDA tensor
    runs the kernel of ``csrc/decode.cu`` (one launch), a CPU tensor
    :func:`decode_proposals_plain` (equal floats); any other device raises.
    ``class_scores`` and ``objectness`` are views of the head's output."""
    out = end_points["proposals_output"]
    if kernel_route(out, "decode_proposals") != "cuda":
        return decode_proposals_plain(end_points, config)
    NC = config.num_class
    out = out.float().contiguous()
    fields = decode_proposals_cuda(out, end_points["proposals_xyz"].float().contiguous(),
                                   class_mean_size(out.device), config.num_heading_bin,
                                   config.num_size_cluster, NC)
    return {"bboxes": fields["bboxes"], "class_scores": out[..., -NC:], "objectness": out[..., :2], **{
        k: fields[k] for k in ("nms_scores", "center_pred", "size_pred", "heading_pred", "size_cls", "heading_cls")}}


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

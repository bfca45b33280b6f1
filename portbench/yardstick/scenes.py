"""Scenes made from the seed: SUN RGB-D-like clouds with their boxes.

The layout of the port's synthetic scenes (``votenet_tpu_torch/data/
synthetic.py``: a room-sized uniform background holding half the points, the
other half split evenly over 1 to 8 oriented boxes of the 10 classes, sized
about each class's mean), drawn in bulk on the device with one generator,
so that every scene of a run costs the same few launches. Every seed gives
the same shapes: only the contents move.

Labels follow the dataset's codecs: the heading's bin and residual (the
residual over pi / NH), the size class (the semantic class) and the size
residual over the class's mean size; per-box arrays are edge-padded to
``max_gt_boxes`` with ``gt_count`` beside them.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.head_ref import MEAN_SIZE

MAX_BOXES = 8


def substream(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of a run's draws."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def make_scenes(seed: int, count: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """``count`` scenes on ``device``: points (S, N, 3) f32 and the boxes
    (S, MAX_BOXES, ...) with ``nbox`` (S,) real ones each."""
    g = torch.Generator(device=device).manual_seed(substream(seed, "scenes"))
    S, N, K = count, cfg["point_num"], MAX_BOXES

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    nbox = torch.randint(1, K + 1, (S,), generator=g, device=device)
    cls = torch.randint(0, cfg["num_class"], (S, K), generator=g, device=device)
    centre = torch.stack([u(-3, 3, S, K), u(-0.5, 1.5, S, K), u(1, 6, S, K)], dim=-1)
    heading = u(-math.pi, math.pi, S, K)
    size = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=device)[cls] * u(0.85, 1.15, S, K, 3)
    n_bg = N // 2
    bg = torch.stack([u(-4, 4, S, n_bg), u(-1, 2, S, n_bg), u(0, 7, S, n_bg)], dim=-1)
    n_fg = N - n_bg
    box_of = (torch.arange(n_fg, device=device)[None, :] * nbox[:, None]) // n_fg  # (S, n_fg), even split
    local = u(-0.5, 0.5, S, n_fg, 3) * torch.gather(size, 1, box_of[..., None].expand(-1, -1, 3))
    h = torch.gather(heading, 1, box_of)
    c, s = torch.cos(h), torch.sin(h)
    x, y, z = local.unbind(-1)
    fg = torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1) + torch.gather(
        centre, 1, box_of[..., None].expand(-1, -1, 3))
    pts = torch.cat([bg, fg], dim=1)
    perm = torch.argsort(torch.rand((S, N), generator=g, device=device), dim=1)
    pts = torch.gather(pts, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    return {"points": pts, "nbox": nbox, "cls": cls, "centre": centre, "heading": heading, "size": size}


def labels(scenes: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, np.ndarray]:
    """The training targets of every scene on the host, edge-padded to
    ``max_gt_boxes``: bboxes_xyz, bboxes_lwh, bboxes_roty, semantic, heading
    and size labels and residuals, gt_count."""
    NH, G = cfg["num_heading_bin"], cfg["max_gt_boxes"]
    nbox = scenes["nbox"].cpu().numpy()
    cls = scenes["cls"].cpu().numpy().astype(np.int32)
    centre = scenes["centre"].cpu().numpy().astype(np.float32)
    heading = scenes["heading"].cpu().numpy().astype(np.float64)
    size = scenes["size"].cpu().numpy().astype(np.float32)
    apc = 2 * np.pi / NH
    shifted = (heading % (2 * np.pi) + apc / 2) % (2 * np.pi)
    hcls = (shifted / apc).astype(np.int32)
    hres = ((shifted - (hcls * apc + apc / 2)) / (np.pi / NH)).astype(np.float32)
    mean = np.asarray(MEAN_SIZE, dtype=np.float32)[cls]
    sres = ((size - mean) / mean).astype(np.float32)
    sel = np.minimum(np.arange(G)[None, :], nbox[:, None] - 1)  # edge padding: the last real box repeated

    def pad(a):
        return np.take_along_axis(a, sel.reshape(sel.shape + (1,) * (a.ndim - 2)), axis=1)

    return {"bboxes_xyz": pad(centre), "bboxes_lwh": pad(size), "bboxes_roty": pad(heading.astype(np.float32)),
            "semantic_labels": pad(cls), "heading_labels": pad(hcls), "heading_residuals": pad(hres),
            "size_labels": pad(cls), "size_residuals": pad(sres), "gt_count": nbox.astype(np.int32)}

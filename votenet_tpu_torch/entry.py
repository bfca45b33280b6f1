"""Single-scene forward at full SUN RGB-D width (port of ``__graft_entry__.entry``)."""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu.config import default_config
from votenet_tpu_torch.predictor import VoteNetPredictor


def entry(device: str | torch.device = "cuda"):
    """Returns ``(forward, example_args)`` at B=1.

    ``forward(points)`` is the full inference path (backbone, voting,
    proposal, decode, 3D NMS) of a full-width VoteNet with weights drawn
    from a seed-0 generator, returning (bboxes, class_scores, keep);
    ``example_args`` holds one (1, 20480, 3) cloud on ``device``.
    """
    cfg = default_config()
    predictor = VoteNetPredictor(cfg, device=device, batch_size=1)

    def forward(points):
        out = predictor(points)
        return out["bboxes"], out["class_scores"], out["keep"]

    example = np.random.RandomState(0).randn(1, cfg.point_num, 3).astype(np.float32)
    return forward, (torch.from_numpy(example).to(device),)

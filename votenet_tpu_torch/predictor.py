"""High-level inference API (port of votenet_tpu/predictor.py).

Weights -> callable detector that serves batched or single-scene requests
on one device with fixed shapes: forward + decode + NMS.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from votenet_tpu.config import Config, default_config
from votenet_tpu.data.geometry import CLASS2TYPE
from votenet_tpu_torch.models.decode import predict_boxes
from votenet_tpu_torch.models.votenet import VoteNet


def _detections(out: Dict[str, np.ndarray], b: int) -> List[Tuple[str, np.ndarray, float]]:
    """Kept boxes of scene ``b``: class = argmax semantic logit, confidence =
    that logit."""
    dets = []
    for pi in np.nonzero(out["keep"][b])[0]:
        cls_idx = int(np.argmax(out["class_scores"][b, pi]))
        dets.append((CLASS2TYPE[cls_idx], out["bboxes"][b, pi], float(out["class_scores"][b, pi, cls_idx])))
    return dets


class VoteNetPredictor:
    """Weights -> callable detector on ``device``.

    ``state_dict`` is the port's (``models.convert.convert_flax_variables``
    turns a JAX checkpoint into one); without it the weights are drawn from
    ``generator`` (seed 0 when not given). On a CUDA device, FPS and the
    ball query run the kernels of ``csrc/``; on the CPU, their plain
    versions. Matmuls stay in full f32: TF32 is switched off for the process.
    """

    def __init__(
        self,
        config: Optional[Config] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda",
        batch_size: int = 8,
        nms_iou: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        self.config = config or default_config()
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.nms_iou = self.config.nms_iou if nms_iou is None else nms_iou
        self.model = VoteNet(self.config, generator)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device)

    @torch.inference_mode()
    def __call__(self, points) -> Dict[str, torch.Tensor]:
        """Raw fixed-shape prediction for a (B, N, 3) batch (numpy or tensor)
        -> bboxes (B, P, 8, 3), class_scores (B, P, NC), keep (B, P) bool,
        objectness (B, P, 2), as tensors on the predictor's device."""
        if not torch.is_tensor(points):
            points = torch.from_numpy(np.asarray(points, dtype=np.float32))
        points = points.to(self.device, torch.float32)
        pred = predict_boxes(self.model(points), self.config, nms_iou=self.nms_iou)
        return {k: pred[k] for k in ("bboxes", "class_scores", "keep", "objectness")}

    def _numpy(self, points) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self(points).items()}

    def detect(self, points: np.ndarray) -> List[Tuple[str, np.ndarray, float]]:
        """Single scene (N, 3) -> [(classname, corners (8, 3), score)]."""
        return _detections(self._numpy(np.asarray(points, np.float32)[None]), 0)

    def detect_batch(self, scenes: List[np.ndarray]) -> List[List[Tuple[str, np.ndarray, float]]]:
        """Many scenes, padded to the predictor's batch size by repeating the
        last scene of a short chunk."""
        results = []
        B = self.batch_size
        for start in range(0, len(scenes), B):
            chunk = list(scenes[start : start + B])
            n_real = len(chunk)
            chunk += [chunk[-1]] * (B - n_real)
            out = self._numpy(np.stack(chunk))
            results.extend(_detections(out, bi) for bi in range(n_real))
        return results

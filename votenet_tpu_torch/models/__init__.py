"""PointNet++ layers, VoteNet, decode and the flax-checkpoint converter."""

from votenet_tpu_torch.models.convert import convert_flax_variables
from votenet_tpu_torch.models.decode import decode_proposals, get_3d_bbox, predict_boxes
from votenet_tpu_torch.models.votenet import VoteNet, check_supported

__all__ = [
    "VoteNet", "check_supported", "convert_flax_variables",
    "decode_proposals", "get_3d_bbox", "predict_boxes",
]

"""PointNet++ layers, VoteNet, the loss, decode and the flax-checkpoint converter."""

from votenet_tpu_torch.models.convert import convert_flax_opt_state, convert_flax_variables, flax_param_path
from votenet_tpu_torch.models.decode import decode_proposals, get_3d_bbox, predict_boxes
from votenet_tpu_torch.models.losses import VoteNetLossOutput, votenet_loss
from votenet_tpu_torch.models.votenet import VoteNet, check_supported

__all__ = [
    "VoteNet", "check_supported", "convert_flax_opt_state", "convert_flax_variables",
    "flax_param_path", "votenet_loss", "VoteNetLossOutput",
    "decode_proposals", "get_3d_bbox", "predict_boxes",
]

"""Point-cloud ops of the port: plain functions on (B, N, C) tensors.

FPS, the ball query and the group_point backward (``scatter_add``) run a
hand-written CUDA kernel for a CUDA tensor and their plain PyTorch version
for a CPU tensor; the choice follows the tensor's device alone
(``ops.common.kernel_route``).
"""

from votenet_tpu_torch.ops.common import pairwise_sqdist
from votenet_tpu_torch.ops.grouping import finalize_first_k, group_point, query_ball_point, scatter_add
from votenet_tpu_torch.ops.interpolate import three_interpolate, three_nn
from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix
from votenet_tpu_torch.ops.nms3d import nms3d
from votenet_tpu_torch.ops.sampling import farthest_point_sample, gather_point

__all__ = [
    "pairwise_sqdist", "farthest_point_sample", "gather_point",
    "query_ball_point", "finalize_first_k", "group_point", "scatter_add",
    "three_nn", "three_interpolate", "box3d_iou_matrix", "nms3d",
]

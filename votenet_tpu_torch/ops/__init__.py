"""Point-cloud ops of the port: plain functions on (B, N, C) tensors.

FPS, the ball query, the group_point backward (``scatter_add``) and the
fused eval SA-layer MLP + max-pool (``fused_sa_mlp_pool``) run a
hand-written CUDA kernel for a CUDA tensor and their plain PyTorch version
for a CPU tensor; the choice follows the tensor's device alone
(``ops.common.kernel_route``). So do two variants no model path calls, the
ports of the JAX package's benchmark prototypes: the ball query that also
returns the grouped coordinates (``query_ball_point_emit_xyz``) and FPS
with an 8-byte candidate exchange (``fps_rowwise_noscalar``). NMS's greedy
and its IoU matrix run kernels of the port's own on a CUDA tensor
(``nms3d``, ``box3d_iou_matrix``), and so does batch norm + ReLU, one
autograd op whose four stages are kernels on the card
(``batch_norm_relu``). The reference's other ops, on no path
(``knn_point``, ``select_top_k``, ``query_ball_point_topk``,
``prob_sample``), the ball query's dense and streaming forms
(``query_ball_point_dense``, ``query_ball_point_streaming``), three_nn's
(``three_nn_dense``, ``three_nn_streaming``) and the elementwise IoU
(``box3d_iou_pairwise``) are plain PyTorch everywhere.
"""

from votenet_tpu_torch.ops.batchnorm import batch_norm_relu
from votenet_tpu_torch.ops.common import pairwise_sqdist
from votenet_tpu_torch.ops.grouping import (
    finalize_first_k,
    group_point,
    knn_point,
    merge_first_k,
    query_ball_point,
    query_ball_point_dense,
    query_ball_point_emit_xyz,
    query_ball_point_streaming,
    query_ball_point_topk,
    scatter_add,
    select_top_k,
)
from votenet_tpu_torch.ops.interpolate import three_interpolate, three_nn, three_nn_dense, three_nn_streaming
from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix, box3d_iou_pairwise
from votenet_tpu_torch.ops.nms3d import nms3d, nms3d_indices
from votenet_tpu_torch.ops.samlp import fused_sa_mlp_pool
from votenet_tpu_torch.ops.sampling import farthest_point_sample, fps_rowwise_noscalar, gather_point, prob_sample

__all__ = [
    "pairwise_sqdist", "farthest_point_sample", "fps_rowwise_noscalar", "gather_point",
    "query_ball_point", "query_ball_point_dense", "query_ball_point_streaming", "query_ball_point_emit_xyz",
    "merge_first_k", "finalize_first_k", "group_point", "scatter_add",
    "three_nn", "three_nn_dense", "three_nn_streaming", "three_interpolate",
    "box3d_iou_pairwise", "box3d_iou_matrix", "nms3d", "nms3d_indices", "fused_sa_mlp_pool",
    "knn_point", "select_top_k", "query_ball_point_topk", "prob_sample", "batch_norm_relu",
]

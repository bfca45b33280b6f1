"""The NMS IoU matrix: the CUDA kernel's wrapper.

Kernel: ``votenet_tpu_torch/csrc/iou3d.cu``, the port's own (the JAX
package computes the matrix in XLA, ``votenet_tpu/ops/iou3d.py:329-353``,
and reaches no Pallas kernel). A block takes a tile of pairs with its boxes
staged once in shared memory, one thread a pair computing the edge-clip IoU
in registers, in the order of the plain version
``ops/iou3d.py::box3d_iou_matrix_plain``, whose floats it equals. Given the
same memory twice (``c1 is c2``, as NMS calls it) it computes the upper
triangle of the self-matrix and writes each float to both halves; see the
note at the top of the source.
"""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda

IOU_TILE = 16  # rows and columns of a tile (csrc/iou3d.cu kTile)


def self_tiles(N: int) -> tuple[np.ndarray, np.ndarray]:
    """The self-matrix's launch over N boxes: (ti, tj) of each block along
    the grid's x, in blockIdx order, the tiles ti <= tj of ``IOU_TILE``
    boxes a side row by row (csrc/iou3d.cu ``self_tile``); the grid is
    their count, tiles (tiles + 1) / 2."""
    tiles = -(-N // IOU_TILE)
    ti = np.repeat(np.arange(tiles), tiles - np.arange(tiles))
    start = np.cumsum(np.concatenate([[0], tiles - np.arange(tiles)]))[:-1]
    return ti, ti + (np.arange(len(ti)) - start[ti])


def box3d_iou_matrix_cuda(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Launch the IoU kernel: c1 (B, N, 8, 3), c2 (B, M, 8, 3), contiguous
    f32 on one CUDA device -> (B, N, M) f32, equal to
    ``ops.iou3d.box3d_iou_matrix_plain``; one triangle of pairs when c1 and
    c2 are the same memory (the matrix is symmetric bit for bit). Raises RuntimeError for a tensor
    that is not on a CUDA device (it never computes the plain version),
    ValueError for other shapes or types. Adds one to
    ``box3d_iou_matrix_cuda.launches`` per call."""
    require_cuda("box3d_iou_matrix_cuda", c1, 4, 3)
    require_cuda("box3d_iou_matrix_cuda", c2, 4, 3)
    B, N, M = c1.shape[0], c1.shape[1], c2.shape[1]
    if c1.shape[2] != 8 or c2.shape[2] != 8 or c2.shape[0] != B or c2.device != c1.device:
        raise ValueError(f"box3d_iou_matrix_cuda: expected (B, N, 8, 3) and (B, M, 8, 3) on one device, got "
                         f"{tuple(c1.shape)} on {c1.device} and {tuple(c2.shape)} on {c2.device}")
    out = torch.empty((B, N, M), dtype=torch.float32, device=c1.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(c1.device):
        err = library().votenet_iou3d(c1.data_ptr(), c2.data_ptr(), B, N, M, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    check_launch(err, "box3d_iou_matrix_cuda")
    box3d_iou_matrix_cuda.launches += 1
    return out


box3d_iou_matrix_cuda.launches = 0

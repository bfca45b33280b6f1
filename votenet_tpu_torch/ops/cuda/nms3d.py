"""The NMS greedy: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/nms3d.cu``, the port's own (the JAX
package's NMS, ``votenet_tpu/ops/nms3d.py:40-58``, is a ``lax.while_loop``
and reaches no Pallas kernel). One CTA a batch row packs the suppression
relation into bit rows in shared memory and one warp walks the priority
order, so the greedy runs in one launch with no host sync; see the note at
the top of the source.

Both versions take the IoU matrix, the priority order and the candidates and
give the keep mask of the greedy: walking ``order``, box i is kept iff it is
a candidate and no kept box before it has IoU strictly above ``thr`` with
it. :func:`nms3d_greedy_plain` walks the order one position at a time, as
the kernel does; the plain version of ``ops.nms3d`` on the CPU is the JAX
package's Jacobi fixpoint (``ops/nms3d.py``), which reaches the same mask.
"""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu_torch.ops.cuda import check_launch, library

# mirror csrc/nms3d.cu's kMaxBoxes: 32 bit words a row, one a lane of the walking warp
NMS_MAX_BOXES = 1024


def nms3d_greedy_plain(iou: torch.Tensor, order: torch.Tensor, cand: torch.Tensor, thr: float) -> torch.Tensor:
    """The kernel's walk in PyTorch: iou (B, N, N) f32, order (B, N) (each
    row a permutation, highest priority first), cand (B, N) bool -> keep
    (B, N) bool. N steps, each deciding one position of every row."""
    B, N = cand.shape
    rows = torch.arange(B, device=cand.device)
    order = order.long()
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(N, device=cand.device).expand(B, N))
    # supp[b, j, i]: candidate j, once kept, suppresses the later box i
    supp = (rank[:, :, None] < rank[:, None, :]) & (iou > thr) & cand[:, :, None]
    blocked = torch.zeros((B, N), dtype=torch.bool, device=cand.device)
    keep = torch.zeros((B, N), dtype=torch.bool, device=cand.device)
    for p in range(N):
        i = order[:, p]
        kept = cand[rows, i] & ~blocked[rows, i]
        keep[rows, i] = kept
        blocked |= kept[:, None] & supp[rows, i]
    return keep


def nms3d_greedy_cuda(iou: torch.Tensor, order: torch.Tensor, cand: torch.Tensor, thr: float) -> torch.Tensor:
    """Launch the greedy kernel: iou (B, N, N) f32, order (B, N) int, cand
    (B, N) bool, all on one CUDA device -> keep (B, N) bool, bit-equal to
    :func:`nms3d_greedy_plain`. No host sync. Raises RuntimeError for a
    tensor that is not on a CUDA device (it never computes the plain
    version), ValueError for N above NMS_MAX_BOXES. Adds one to
    ``nms3d_greedy_cuda.launches`` per call."""
    B, N = cand.shape
    if N > NMS_MAX_BOXES:
        raise ValueError(f"nms3d_greedy_cuda: a batch row holds at most {NMS_MAX_BOXES} boxes "
                         f"(the kernel's shared-memory bit rows), got {N}")
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in (iou, order, cand)):
        raise RuntimeError("nms3d_greedy_cuda: the CUDA kernel needs CUDA tensors, got "
                           f"{[getattr(t, 'device', type(t)) for t in (iou, order, cand)]}")
    if tuple(iou.shape) != (B, N, N) or tuple(order.shape) != (B, N) or B < 1 or N < 1:
        raise ValueError(f"nms3d_greedy_cuda: iou {tuple(iou.shape)}, order {tuple(order.shape)} and "
                         f"cand {tuple(cand.shape)} do not fit (B, N, N), (B, N), (B, N)")
    iou = iou.float().contiguous()
    order = order.to(torch.int32).contiguous()
    cand = cand.to(torch.bool).contiguous()
    keep = torch.empty((B, N), dtype=torch.bool, device=iou.device)
    lib = library()
    with torch.cuda.device(iou.device):
        err = lib.votenet_nms3d(iou.data_ptr(), order.data_ptr(), cand.data_ptr(), B, N,
                                float(np.float32(thr)), keep.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "nms3d_greedy_cuda")
    nms3d_greedy_cuda.launches += 1
    return keep


nms3d_greedy_cuda.launches = 0

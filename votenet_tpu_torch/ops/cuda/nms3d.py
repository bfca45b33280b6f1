"""The NMS greedy: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/nms3d.cu``, the port's own (the JAX
package's NMS, ``votenet_tpu/ops/nms3d.py:40-58``, is a stable argsort and a
``lax.while_loop``, and reaches no Pallas kernel). Up to ``NMS_SMEM_BOXES``
boxes a row, one CTA a batch row ranks the scores, packs the suppression
relation into bit rows by order position in shared memory and walks the
order in chunks of 32 positions: the greedy in one launch with no host
sync. Longer rows rank in a first launch, pack their bit rows into a global
workspace in a second and walk them in a third; see the note at the top of
the source.

The kernel takes the IoU matrix, the scores and the objectness logits. Its
plain version is ``ops/nms3d.py``'s CPU route: the candidates, the stable
argsort and the Jacobi fixpoint (``nms3d_jacobi_plain``). Walking
``order``, box i is kept iff it is a candidate and no kept box before it has
IoU strictly above ``thr`` with it; :func:`nms3d_greedy_plain` walks the
order one position at a time and reaches the fixpoint's mask.
"""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu_torch.ops.cuda import check_launch, library

# mirror csrc/nms3d.cu's kMaxBoxes: the longest row whose bit rows the
# one-launch route keeps in shared memory (32 words a row, one a lane of the
# walking warp); longer rows take the workspace route
NMS_SMEM_BOXES = 1024


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


def nms3d_greedy_cuda(iou: torch.Tensor, scores: torch.Tensor, objectness: torch.Tensor, thr: float) -> torch.Tensor:
    """Launch the greedy kernel: iou (B, N, N), scores (B, N) and objectness
    (B, N, 2) f32, all on one CUDA device (objectness may be a view with any
    strides but the last) -> keep (B, N) bool, the greedy over the order
    ``torch.argsort(scores, dim=1, descending=True, stable=True)`` of the
    candidates ``objectness[..., 1] > objectness[..., 0]``: bit-equal to
    :func:`nms3d_greedy_plain` and the fixpoint on that order, at any N
    (above ``NMS_SMEM_BOXES`` through a workspace of
    ``votenet_nms3d_workspace_words`` words). The kernel ranks the scores
    and reads the candidates itself: no sort is launched, and there is no
    host sync. Raises RuntimeError for a tensor that is not on a CUDA device
    (it never computes the plain version). Adds one to
    ``nms3d_greedy_cuda.launches`` per call."""
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in (iou, scores, objectness)):
        raise RuntimeError("nms3d_greedy_cuda: the CUDA kernel needs CUDA tensors, got "
                           f"{[getattr(t, 'device', type(t)) for t in (iou, scores, objectness)]}")
    B, N = scores.shape
    if (tuple(iou.shape) != (B, N, N) or tuple(objectness.shape) != (B, N, 2) or B < 1 or N < 1
            or any(t.dtype != torch.float32 for t in (iou, scores, objectness))):
        raise ValueError(f"nms3d_greedy_cuda: iou {tuple(iou.shape)} {iou.dtype}, scores {tuple(scores.shape)} "
                         f"{scores.dtype} and objectness {tuple(objectness.shape)} {objectness.dtype} do not fit "
                         "f32 (B, N, N), (B, N), (B, N, 2)")
    iou, scores = iou.contiguous(), scores.contiguous()
    if objectness.stride(-1) != 1:
        objectness = objectness.contiguous()
    keep = torch.empty((B, N), dtype=torch.bool, device=iou.device)
    lib = library()
    words = lib.votenet_nms3d_workspace_words(B, N)
    workspace = torch.empty(words, dtype=torch.int32, device=iou.device) if words else None
    with torch.cuda.device(iou.device):
        err = lib.votenet_nms3d(iou.data_ptr(), scores.data_ptr(), objectness.data_ptr(), objectness.stride(0),
                                objectness.stride(1), B, N, float(np.float32(thr)), keep.data_ptr(),
                                None if workspace is None else workspace.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    check_launch(err, "nms3d_greedy_cuda")
    nms3d_greedy_cuda.launches += 1
    return keep


nms3d_greedy_cuda.launches = 0

"""Oriented 3D non-max suppression (port of votenet_tpu/ops/nms3d.py).

Semantics: candidates are the boxes whose objectness logit[1] > logit[0]
(strict); in priority order "score descending, index ascending", a candidate
is kept iff no kept candidate of higher priority in the same batch row has
IoU strictly above the threshold.

Both routes build the dense (B, N, N) IoU matrix with ``box3d_iou_matrix``:
on a CUDA tensor the kernel of ``csrc/iou3d.cu``, on a CPU tensor its plain
version, which compute equal floats, so the threshold test sees the same
IoU on either device and the keep masks are equal. On a CUDA tensor the
greedy is the kernel of ``csrc/nms3d.cu``, for any N: it ranks the scores
in the argsort's order itself, with no host sync (``ops/cuda/nms3d.py``).
On a CPU tensor it is the stable argsort and the JAX package's Jacobi
fixpoint, one host sync a round. The JAX package picks a compaction
tier (64, 160 or dense) with ``lax.cond`` on the candidate count; the tiers
give the same keep mask by construction (suppression flows only from higher
to lower priority among candidates), so they only save IoU work. Choosing a
tier here would need the count on the host, one sync a call, which is what
the kernel removes: the port has no tiers; the kernel compacts the
candidates inside its CTA instead, for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda
from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix


def nms3d(
    corners: torch.Tensor,
    scores: torch.Tensor,
    objectness: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy oriented 3D NMS -> keep (B, N) bool.

    corners (B, N, 8, 3), scores (B, N), objectness (B, N, 2). A CUDA tensor
    runs two kernels, the IoU matrix (one triangle of the self-matrix) and
    the greedy, which ranks the scores and reads the candidates itself: no
    host sync, no sort. A CPU tensor runs the IoU's plain version, the
    stable argsort and :func:`nms3d_jacobi_plain`; any other device raises.
    """
    return nms3d_on_iou(box3d_iou_matrix(corners, corners), scores, objectness, iou_threshold)


def nms3d_on_iou(iou: torch.Tensor, scores: torch.Tensor, objectness: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """The greedy of :func:`nms3d` on its IoU self-matrix (B, N, N): the
    kernel of ``csrc/nms3d.cu`` for a CUDA tensor, the stable argsort and
    :func:`nms3d_jacobi_plain` for a CPU tensor."""
    if kernel_route(scores, "nms3d") == "cuda":
        return nms3d_greedy_cuda(iou, scores.float(), objectness.float(), iou_threshold)
    cand = objectness[..., 1] > objectness[..., 0]
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    return nms3d_jacobi_plain(iou, order, cand, iou_threshold)


def nms3d_jacobi_plain(iou: torch.Tensor, order: torch.Tensor, cand: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """The greedy as a Jacobi fixpoint (the JAX package's ``_jacobi_greedy``):
    every round recomputes "kept = candidate and no kept higher-priority box
    overlaps it" for all boxes at once, and the first round that changes
    nothing is the greedy result. Host syncs: one per round, to test for the
    fixpoint; the rounds number the longest suppression chain plus one (at
    most N + 1)."""
    B, N = cand.shape
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(N, device=order.device).expand(B, N))
    higher = rank[:, :, None] < rank[:, None, :]  # [b, j, i]: j before i
    # supp[b, j, i]: candidate j, once kept, suppresses i
    supp = higher & (iou > iou_threshold) & cand[:, :, None]
    kept = cand
    while True:
        blocked = torch.any(kept[:, :, None] & supp, dim=1)
        new_kept = cand & ~blocked
        if torch.equal(new_kept, kept):
            return kept
        kept = new_kept


def nms3d_indices(corners, scores, objectness, iou_threshold: float) -> np.ndarray:
    """The reference op's output format (tf_nms3d.cpp:266-283, the JAX
    package's ``nms3d_indices``): (K, 2) int32 (batch, box) pairs of the kept
    boxes, in descending score over the whole batch (one priority queue),
    ties in (batch, box) order. Takes tensors or arrays; returns numpy."""
    keep = nms3d(torch.as_tensor(corners), torch.as_tensor(scores), torch.as_tensor(objectness), iou_threshold)
    keep = keep.cpu().numpy()
    scores = torch.as_tensor(scores).cpu().numpy()
    b_idx, n_idx = np.nonzero(keep)
    order = np.argsort(-scores[b_idx, n_idx], kind="stable")
    return np.stack([b_idx[order], n_idx[order]], axis=1).astype(np.int32)

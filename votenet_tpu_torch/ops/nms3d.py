"""Oriented 3D non-max suppression (port of votenet_tpu/ops/nms3d.py).

Semantics: candidates are the boxes whose objectness logit[1] > logit[0]
(strict); in priority order "score descending, index ascending", a candidate
is kept iff no kept candidate of higher priority in the same batch row has
IoU strictly above the threshold.

The port always builds the dense (B, N, N) IoU matrix. The JAX package picks
a compaction tier (64, 160 or dense) with ``lax.cond`` on the candidate
count; the tiers give the same keep mask by construction (suppression flows
only from higher to lower priority among candidates), so they only save IoU
work. Choosing a tier eagerly would cost one more host sync.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix


def nms3d(
    corners: torch.Tensor,
    scores: torch.Tensor,
    objectness: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy oriented 3D NMS -> keep (B, N) bool.

    corners (B, N, 8, 3), scores (B, N), objectness (B, N, 2).

    The greedy is solved as a Jacobi fixpoint: every round recomputes
    "kept = candidate and no kept higher-priority box overlaps it" for all
    boxes at once, and the first round that changes nothing is the greedy
    result. Host syncs: one per round, to test for the fixpoint; the rounds
    number the longest suppression chain plus one (at most N + 1).
    """
    B, N = scores.shape
    cand = objectness[..., 1] > objectness[..., 0]
    iou = box3d_iou_matrix(corners, corners)  # (B, N, N)
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(N, device=scores.device).expand(B, N))
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

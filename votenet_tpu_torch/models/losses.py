"""VoteNet training losses, fixed-shape and mask-based (port of
votenet_tpu/models/losses.py).

The reference's variable-length index sets become masks over static shapes,
as in the JAX package (see its module docstring, the authoritative
statement): positives and negatives are boolean masks over the proposal
axis, and a "mean over the selected set" is a masked sum over its count,
with the count clamped at 1 so that an empty set gives a 0 term, not NaN.
GT boxes arrive edge-padded to ``max_gt_boxes``; ``pad_semantics``
"reference" lets the replicas up to the batch's largest ``gt_count`` feed
the GT-axis reductions (as the reference's per-batch padding did),
"masked" only each scene's real boxes.

Ties: ``torch.argmin``/``argmax`` return the first extremal index, as
``jnp.argmin``/``argmax`` do; the edge-padded GT boxes tie by construction.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from votenet_tpu.config import Config


class VoteNetLossOutput(NamedTuple):
    total: torch.Tensor
    vote_reg_loss: torch.Tensor
    obj_cls_loss: torch.Tensor
    box_loss: torch.Tensor
    sem_cls_loss: torch.Tensor
    center_loss: torch.Tensor
    heading_cls_loss: torch.Tensor
    heading_res_loss: torch.Tensor
    size_cls_loss: torch.Tensor
    size_res_loss: torch.Tensor
    obj_accuracy: torch.Tensor
    sem_accuracy: torch.Tensor
    num_positive: torch.Tensor
    num_negative: torch.Tensor


def _huber(pred, gt, delta: float = 1.0):
    """tf.losses.huber_loss elementwise (delta=1, reduction NONE)."""
    err = pred - gt
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def _sparse_ce(logits, labels):
    """Per-element softmax cross entropy with integer labels."""
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _gather_per_proposal(gt_attr: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """gt_attr (B, G, ...) indexed by assignment (B, P) -> (B, P, ...)."""
    idx = assignment.long()
    while idx.dim() < gt_attr.dim():
        idx = idx[..., None]
    idx = idx.expand(tuple(assignment.shape) + tuple(gt_attr.shape[2:]))
    return torch.gather(gt_attr, 1, idx)


def _rotate_abs_dist_along_y(d: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Apply R_y(angle[b, g]) to vectors d[b, n, g, :] (model.py:64-74)."""
    c, s = torch.cos(angle)[:, None, :], torch.sin(angle)[:, None, :]  # (B, 1, G)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]  # (B, N, G)
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def votenet_loss(
    end_points: Dict[str, torch.Tensor],
    gt: Dict[str, torch.Tensor],
    config: Config,
    pad_semantics: str = "reference",
) -> VoteNetLossOutput:
    """The full VoteNet loss (reference model.py:62-233), term for term the
    JAX package's ``votenet_loss``.

    ``gt`` fields (all edge-padded to G = config.max_gt_boxes):
      bboxes_xyz (B,G,3), bboxes_lwh (B,G,3), bboxes_roty (B,G),
      semantic_labels/heading_labels/size_labels (B,G) int,
      heading_residuals (B,G), size_residuals (B,G,3), gt_count (B,) int.
    """
    cfg = config
    seeds_xyz = end_points["seeds_xyz"]  # (B, N, 3)
    votes_xyz = end_points["votes_xyz"]
    proposals_xyz = end_points["proposals_xyz"]  # (B, P, 3)
    out = end_points["proposals_output"]  # (B, P, 79)

    bboxes_xyz = gt["bboxes_xyz"]
    B, G = bboxes_xyz.shape[0], bboxes_xyz.shape[1]
    gt_count = gt["gt_count"]
    if pad_semantics == "reference":
        gt_limit = torch.clamp(torch.max(gt_count), min=1)
    elif pad_semantics == "masked":
        gt_limit = torch.clamp(gt_count, min=1)[..., None]
    else:
        raise ValueError(f"pad_semantics={pad_semantics!r}")
    box_iota = torch.arange(G, device=bboxes_xyz.device)
    dual_mask = (box_iota[None, :] < gt_limit).expand(B, G)

    # ---- vote regression loss (model.py:62-84) ----
    diff = seeds_xyz[:, :, None, :] - bboxes_xyz[:, None, :, :]  # (B, N, G, 3)
    dist2center = torch.abs(diff)
    rot = _rotate_abs_dist_along_y(dist2center, -gt["bboxes_roty"])
    inside = torch.all(rot < gt["bboxes_lwh"][:, None, :, :] / 2.0, dim=-1)  # (B, N, G)
    surface_ind = torch.any(inside, dim=-1)  # (B, N)
    votes_assignment = torch.argmin(_norm(dist2center), dim=-1)  # (B, N)
    assigned_center = _gather_per_proposal(bboxes_xyz, votes_assignment)
    l1 = torch.sum(torch.abs(votes_xyz - assigned_center), dim=-1)
    vote_reg_loss = torch.mean(l1 * surface_ind.to(l1.dtype))

    # ---- proposal-GT assignment (model.py:148-155) ----
    dist_mat = _norm(proposals_xyz[:, :, None, :] - bboxes_xyz[:, None, :, :])  # (B, P, G)
    bboxes_assignment = torch.argmin(dist_mat, dim=-1)  # (B, P)
    min_dist = torch.amin(dist_mat, dim=-1)
    positive = min_dist < cfg.positive_thres
    negative = min_dist > cfg.negative_thres

    # ---- objectness (model.py:158-166) ----
    obj_logits = out[..., :2]
    obj_cls_loss = _masked_mean(
        _sparse_ce(obj_logits, torch.ones_like(bboxes_assignment)), positive
    ) + _masked_mean(_sparse_ce(obj_logits, torch.zeros_like(bboxes_assignment)), negative)
    obj_pred = torch.argmax(obj_logits, dim=-1)
    n_pos = torch.sum(positive)
    n_neg = torch.sum(negative)
    obj_correct = torch.sum((obj_pred == 1) & positive) + torch.sum((obj_pred == 0) & negative)
    obj_accuracy = obj_correct / torch.clamp(n_pos + n_neg, min=1)

    # ---- center loss + dual chamfer (model.py:169-182) ----
    center_gt = _gather_per_proposal(bboxes_xyz, bboxes_assignment)
    delta_pred = out[..., 2:5]
    center_loss_main = _masked_mean(
        torch.sum(_huber(delta_pred, center_gt - proposals_xyz), dim=-1), positive
    )
    assignment_dual = torch.argmin(dist_mat, dim=1)  # (B, G)
    prop_xyz_dual = _gather_per_proposal(proposals_xyz, assignment_dual)
    delta_pred_dual = _gather_per_proposal(delta_pred, assignment_dual)
    center_loss_dual = _masked_mean(
        torch.sum(_huber(delta_pred_dual, bboxes_xyz - prop_xyz_dual), dim=-1), dual_mask
    )
    center_loss = center_loss_main + center_loss_dual

    # ---- heading (model.py:185-193) ----
    NH, NS, NC = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class
    heading_cls_gt = _gather_per_proposal(gt["heading_labels"], bboxes_assignment)
    heading_cls_loss = _masked_mean(_sparse_ce(out[..., 5 : 5 + NH], heading_cls_gt), positive)
    heading_res_gt = _gather_per_proposal(gt["heading_residuals"], bboxes_assignment)
    heading_res_pred = torch.gather(
        out[..., 5 + NH : 5 + 2 * NH], -1, heading_cls_gt[..., None].long()
    )[..., 0]
    heading_res_loss = _masked_mean(_huber(heading_res_pred, heading_res_gt), positive)

    # ---- size (model.py:196-205) ----
    size_cls_gt = _gather_per_proposal(gt["size_labels"], bboxes_assignment)
    size_cls_loss = _masked_mean(
        _sparse_ce(out[..., 5 + 2 * NH : 5 + 2 * NH + NS], size_cls_gt), positive
    )
    size_res_gt = _gather_per_proposal(gt["size_residuals"], bboxes_assignment)  # (B, P, 3)
    P = size_cls_gt.shape[1]
    size_res_pred_all = out[..., 5 + 2 * NH + NS : 5 + 2 * NH + 4 * NS].reshape(B, P, NS, 3)
    size_res_pred = torch.gather(
        size_res_pred_all, 2, size_cls_gt.long()[..., None, None].expand(B, P, 1, 3)
    )[..., 0, :]
    size_res_loss = _masked_mean(torch.sum(_huber(size_res_pred, size_res_gt), dim=-1), positive)

    box_loss = (
        center_loss
        + cfg.w_heading_cls * heading_cls_loss
        + heading_res_loss
        + cfg.w_size_cls * size_cls_loss
        + size_res_loss
    )

    # ---- semantic (model.py:210-216) ----
    sem_logits = out[..., -NC:]
    sem_cls_gt = _gather_per_proposal(gt["semantic_labels"], bboxes_assignment)
    sem_cls_loss = _masked_mean(_sparse_ce(sem_logits, sem_cls_gt), positive)
    sem_accuracy = _masked_mean(
        (torch.argmax(sem_logits, dim=-1) == sem_cls_gt).to(torch.float32), positive
    )

    total = vote_reg_loss + cfg.w_obj * obj_cls_loss + cfg.w_box * box_loss + cfg.w_sem * sem_cls_loss
    return VoteNetLossOutput(
        total=total,
        vote_reg_loss=vote_reg_loss,
        obj_cls_loss=obj_cls_loss,
        box_loss=box_loss,
        sem_cls_loss=sem_cls_loss,
        center_loss=center_loss,
        heading_cls_loss=heading_cls_loss,
        heading_res_loss=heading_res_loss,
        size_cls_loss=size_cls_loss,
        size_res_loss=size_res_loss,
        obj_accuracy=obj_accuracy,
        sem_accuracy=sem_accuracy,
        num_positive=n_pos,
        num_negative=n_neg,
    )

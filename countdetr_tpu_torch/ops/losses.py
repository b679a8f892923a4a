"""Losses of both stages and the stage-2 matching cost
(countdetr_tpu/ops/losses.py; reference 1st-stage anchor_detr.py:317-337
BoundingBoxCriterion, 2nd-stage anchor_detr.py:143-367 SetCriterion,
matcher.py:197-247, segmentation.py:198-223).

Everything works on fixed-shape padded tensors with validity masks, so a
batch needs no per-image loop and no host sync.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from countdetr_tpu_torch.ops import boxes as box_ops


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss, the shape of logits (no reduction)."""
    prob = torch.sigmoid(logits)
    # stable BCE-with-logits: max(x, 0) - x z + log1p(exp(-|x|))
    ce = logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def stage1_criterion(
    pred_wh: torch.Tensor,  # (B, Q, 2) normalized predicted w, h per point query
    tgt_points: torch.Tensor,  # (B, Q, 2) normalized point centres (the anchors)
    tgt_whs: torch.Tensor,  # (B, Q, 2) normalized exemplar w, h
    valid: torch.Tensor,  # (B, Q) bool, real queries
) -> Dict[str, torch.Tensor]:
    """Unweighted stage-1 losses; the queries are the annotated points, so
    there is no matching. loss_wh is the L1 mean over valid elements;
    loss_giou sums 1 - GIoU over valid queries of the two boxes that share
    the point as centre, over their count. The caller weighs
    {loss_wh: 1, loss_giou: 0.4}."""
    v = valid.to(pred_wh.dtype)
    n = v.sum().clamp(min=1.0)
    loss_wh = ((pred_wh - tgt_whs).abs() * v[..., None]).sum() / (2.0 * n).clamp(min=1.0)
    src_boxes = torch.cat([tgt_points, pred_wh], dim=-1)
    tgt_boxes = torch.cat([tgt_points, tgt_whs], dim=-1)
    giou = box_ops.generalized_box_iou_aligned(
        box_ops.box_cxcywh_to_xyxy(src_boxes), box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1.0 - giou) * v).sum() / n
    return {"loss_wh": loss_wh, "loss_giou": loss_giou}


class MatchedTargets(NamedTuple):
    """A batched match over padded targets.

    tgt2query (B, T) int: query assigned to each target slot;
    tgt_valid (B, T) bool: real targets;
    matched (B, T) bool or None: targets that won a query. None means every
      valid target did (T <= Q). With more targets than queries only
      min(Q, #valid) match; the others still count in num_boxes.
    """

    tgt2query: torch.Tensor
    tgt_valid: torch.Tensor
    matched: Optional[torch.Tensor] = None


def stage2_criterion(
    pred_logits: torch.Tensor,  # (B, Q, C), C = 2
    pred_boxes: torch.Tensor,  # (B, Q, 4) cxcywh
    pred_vars: torch.Tensor,  # (B, Q, 2) Laplace scales of (w, h)
    tgt_boxes: torch.Tensor,  # (B, T, 4) cxcywh, padded
    tgt_labels: torch.Tensor,  # (B, T) int, 0 = foreground
    match: MatchedTargets,
    focal_alpha: float = 0.25,
    num_boxes: Optional[torch.Tensor] = None,
    batch_valid: Optional[torch.Tensor] = None,  # (B,) bool, real batch rows
) -> Dict[str, torch.Tensor]:
    """Unweighted stage-2 losses given an assignment; the caller weighs
    {loss_ce: 2, loss_bbox: 5, loss_giou: 2, loss_variance: 2}."""
    B, Q, C = pred_logits.shape
    tq = match.tgt2query.long()
    tv = match.tgt_valid
    matched = match.matched if match.matched is not None else tv
    vf = tv.to(pred_boxes.dtype)
    mf = matched.to(pred_boxes.dtype)
    if num_boxes is None:
        # every valid target, matched or not (reference anchor_detr.py:318-325)
        num_boxes = vf.sum().clamp(min=1.0)

    # focal classification (reference :166-197). The reference's one-hot
    # has C+1 columns over num_classes=1, so unmatched queries keep an
    # explicit background one-hot at class C-1; matched ones get their label.
    q_idx = torch.where(matched, tq, Q)  # unmatched targets land in row Q
    target_classes = torch.full((B, Q + 1), C - 1, dtype=torch.long, device=tq.device)
    target_classes.scatter_(1, q_idx, tgt_labels.long())
    onehot = F.one_hot(target_classes[:, :Q], C).to(pred_logits.dtype)
    focal = sigmoid_focal_loss(pred_logits, onehot, alpha=focal_alpha)
    if batch_valid is not None:
        focal = focal * batch_valid[:, None, None].to(focal.dtype)
    loss_ce = focal.sum() / num_boxes

    # box losses on matched pairs (reference :213-234)
    src_boxes = pred_boxes.gather(1, tq[..., None].expand(-1, -1, 4))  # (B, T, 4)
    loss_bbox = ((src_boxes - tgt_boxes).abs() * mf[..., None]).sum() / num_boxes
    giou = box_ops.generalized_box_iou_aligned(
        box_ops.box_cxcywh_to_xyxy(src_boxes), box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1.0 - giou) * mf).sum() / num_boxes

    # Laplace variance (reference :264-289): the SCALAR matched-mean L1 of
    # (w, h), divided by each |sigma|, plus |log sigma|
    src_vars = pred_vars.gather(1, tq[..., None].expand(-1, -1, 2))  # (B, T, 2)
    n_matched = mf.sum().clamp(min=1.0)
    mean_l1_wh = ((src_boxes[..., 2:] - tgt_boxes[..., 2:]).abs()
                  * mf[..., None]).sum(dim=(0, 1)) / n_matched  # (2,)
    abs_var = src_vars.abs().clamp(min=1e-8)
    per_t = mean_l1_wh / abs_var + torch.log(abs_var).abs()
    loss_variance = (per_t.sum(-1) * mf).sum() / num_boxes

    with torch.no_grad():  # log-only terms (reference :194-211)
        card_pred = (pred_logits.argmax(-1) != C - 1).sum(1)
        card_err = (card_pred.float() - vf.sum(1).float()).abs().mean()
        matched_logits = pred_logits.gather(1, tq[..., None].expand(-1, -1, C))
        correct = (matched_logits.argmax(-1) == tgt_labels.long()).float()
        acc = (correct * mf).sum() / mf.sum().clamp(min=1.0)
        class_error = 100.0 * (1.0 - acc)

    return {
        "loss_ce": loss_ce,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
        "loss_variance": loss_variance,
        "cardinality_error": card_err,
        "class_error": class_error,
    }


def stage2_cost_matrix(
    pred_logits: torch.Tensor,  # (B, Q, C)
    pred_boxes: torch.Tensor,  # (B, Q, 4)
    tgt_boxes: torch.Tensor,  # (B, T, 4)
    tgt_labels: torch.Tensor,  # (B, T)
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
) -> torch.Tensor:
    """Matching cost (B, Q, T): the focal-style class cost at the target's
    label, L1 of the boxes and negative GIoU (reference matcher.py:197-247)."""
    prob = torch.sigmoid(pred_logits)
    neg = (1.0 - focal_alpha) * prob**focal_gamma * -torch.log(1.0 - prob + 1e-8)
    pos = focal_alpha * (1.0 - prob) ** focal_gamma * -torch.log(prob + 1e-8)
    B, Q, _ = pred_logits.shape
    T = tgt_boxes.shape[1]
    cost_cls = (pos - neg).gather(2, tgt_labels.long()[:, None, :].expand(B, Q, T))
    l1 = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou_pairwise(
        box_ops.box_cxcywh_to_xyxy(pred_boxes), box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    return cost_bbox * l1 + cost_class * cost_cls + cost_giou * (-giou)

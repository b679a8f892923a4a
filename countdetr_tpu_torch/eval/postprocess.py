"""Inference post-processing (countdetr_tpu/eval/postprocess.py).

adaptive_threshold_counting is the reference's counting rule (2nd-stage
engine.py:117-133): threshold class-0 scores at 0.5, count n survivors,
re-threshold at the (2n-1)-th highest score unless 2n-1 >= 900 (then 0).
topk_postprocess mirrors PostProcess (reference anchor_detr.py:340-372).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


def adaptive_threshold_counting(
    object_prob: np.ndarray,  # (Q,) sigmoid prob of class 0
    base_threshold: float = 0.5,
    cap: int = 900,
) -> Tuple[np.ndarray, float]:
    """Returns (bool keep mask, final threshold), on the host."""
    num_obj = int((object_prob >= base_threshold).sum())
    sorted_desc = np.sort(object_prob)[::-1]
    idx = num_obj * 2 - 1
    if idx < cap:
        # reference quirk: with num_obj == 0 this indexes -1, the LOWEST
        # score, so everything is kept (engine.py:127-128)
        threshold = float(sorted_desc[idx])
    else:
        threshold = 0.0
    return object_prob >= threshold, threshold


def topk_postprocess(
    pred_logits: torch.Tensor,  # (B, Q, C)
    pred_boxes: torch.Tensor,  # (B, Q, 4) cxcywh normalized
    target_sizes: torch.Tensor,  # (B, 2) (h, w) pixels
    k: int = 100,
) -> Dict[str, torch.Tensor]:
    """Top-k over the flattened (query, class) sigmoid scores; boxes xyxy in
    pixels."""
    B, Q, C = pred_logits.shape
    prob = torch.sigmoid(pred_logits).reshape(B, Q * C)
    scores, idx = prob.topk(k, dim=1)
    qidx = idx // C
    labels = idx % C
    boxes = box_cxcywh_to_xyxy(pred_boxes)
    boxes = torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, 4))
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1)[:, None, :]
    return {"scores": scores, "labels": labels, "boxes": boxes * scale}

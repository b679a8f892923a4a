"""Box utilities (countdetr_tpu/ops/boxes.py; reference util/box_ops.py).

cxcywh: (center_x, center_y, w, h), normalized; xyxy: (x0, y0, x1, y1).
Pairwise functions take (..., N, 4) and (..., M, 4) and return (..., N, M);
aligned ones take two (..., 4) and return (...).
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, (..., N, 4) -> (..., N)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes; returns (iou, union). The union is
    clamped away from 0, so degenerate boxes give 0, not NaN."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise GIoU of xyxy boxes (reference util/box_ops.py:46-69)."""
    iou, union = box_iou_pairwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of two (..., 4) xyxy box sets; returns (iou, union)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise GIoU: the diagonal of the pairwise matrix."""
    iou, union = box_iou_aligned(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with the reference's clamping (util/misc.py:478-482)."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)

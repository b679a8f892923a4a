"""Anchor DETR's ``PostProcess`` in plain PyTorch (github.com/megvii-research
/AnchorDETR ``models/anchor_detr.py``; ``CountDETR_147_1st_stage/models/
anchor_detr.py:340-372``), for the check of what ``Predictor.predict``
serves a detector's request: the sigmoid of every (query, class) logit,
the top k of each image's flattened scores, each one's query's box turned
from normalised cxcywh to xyxy and scaled to the image's pixels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def post_process(logits: torch.Tensor, boxes: torch.Tensor, sizes_hw: torch.Tensor,
                 k: int = 100) -> Dict[str, torch.Tensor]:
    """logits (B, Q, C), boxes (B, Q, 4) normalised cxcywh, sizes_hw (B, 2)
    float (h, w) in pixels -> {scores (B, k), labels (B, k), boxes (B, k, 4)
    xyxy in pixels}."""
    prob = logits.sigmoid()
    scores, index = torch.topk(prob.view(logits.shape[0], -1), k, dim=1)
    query = index // logits.shape[2]
    labels = index % logits.shape[2]
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    xyxy = torch.gather(xyxy, 1, query.unsqueeze(-1).repeat(1, 1, 4))
    img_h, img_w = sizes_hw.unbind(1)
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return {"scores": scores, "labels": labels, "boxes": xyxy * scale[:, None, :]}


def served(logits: torch.Tensor, boxes: torch.Tensor, sizes_wh, k: int = 100) -> List[Dict]:
    """A call's results from its forward outputs on their device, the
    images' (w, h) in pixels: each request's ``scores``, ``labels`` and
    ``boxes_xyxy_px`` as numpy arrays."""
    hw = torch.tensor([(h, w) for w, h in sizes_wh], dtype=torch.float32, device=logits.device)
    out = {n: v.cpu().numpy() for n, v in post_process(logits, boxes, hw, k).items()}
    return [{"scores": out["scores"][i], "labels": out["labels"][i],
             "boxes_xyxy_px": out["boxes"][i]} for i in range(len(sizes_wh))]


def same(got: Dict, want: Dict) -> bool:
    """Bit-equal results: the scores, the labels and the boxes."""
    return all(np.array_equal(np.asarray(got[n]), want[n])
               for n in ("scores", "labels", "boxes_xyxy_px"))

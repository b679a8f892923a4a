"""The counting rule and the served result it gives, written from the
reference Counting-DETR's stage-2 engine (threshold the class-0 sigmoid at
0.5, count the n survivors, re-threshold at the (2n - 1)-th highest score,
or at 0 where 2n - 1 reaches 900; n = 0 indexes the lowest score, so
everything is kept), for the check of what ``Predictor.predict`` served.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def threshold_keep(prob: np.ndarray, base: float = 0.5, cap: int = 900):
    n = int((prob >= base).sum())
    ranked = np.sort(prob)[::-1]
    idx = 2 * n - 1
    threshold = float(ranked[idx]) if idx < cap else 0.0
    return prob >= threshold, threshold


def served(logits: np.ndarray, boxes: np.ndarray, sizes: List[Tuple[int, int]]) -> List[Dict]:
    """The results of one call from its (B, Q, 2) class logits and (B, Q, 4)
    normalised cxcywh boxes (float32, as the forward returned them), the
    images' (w, h) in pixels; the sigmoid is taken over the whole batch at
    once, as a server does."""
    prob = 1.0 / (1.0 + np.exp(-logits[..., 0]))
    out = []
    for i, (w, h) in enumerate(sizes):
        keep, threshold = threshold_keep(prob[i])
        out.append({"count": int(keep.sum()), "threshold": threshold,
                    "boxes_cxcywh_px": boxes[i][keep] * (w, h, w, h), "scores": prob[i][keep]})
    return out


def same(got: Dict, want: Dict) -> bool:
    """Bit-equal results: the count, the threshold, the boxes and scores."""
    return (got["count"] == want["count"] and got["threshold"] == want["threshold"]
            and np.array_equal(np.asarray(got["boxes_cxcywh_px"]), want["boxes_cxcywh_px"])
            and np.array_equal(np.asarray(got["scores"]), want["scores"]))

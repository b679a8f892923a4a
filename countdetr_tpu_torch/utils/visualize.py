"""Drawing detections and plotting training logs
(countdetr_tpu/utils/visualize.py; reference util/plot_utils.py:22-120 and
the evaluators' image dumps, eval_all.py:183-225). Pillow and matplotlib
are imported where they are used.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np


def draw_detections(image, boxes_cxcywh_px: np.ndarray, points_px: Optional[np.ndarray] = None,
                    scores: Optional[np.ndarray] = None, color=(0, 220, 0),
                    point_color=(255, 60, 60)):
    """A PIL image with the boxes (and anchor points, and scores) drawn on
    ``image`` (a PIL image or a uint8 HWC array) (reference
    util/plot_utils.py:22-40, draw_pseudo_label)."""
    from PIL import Image, ImageDraw

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image.astype(np.uint8))
    img = image.convert("RGB").copy()
    d = ImageDraw.Draw(img)
    for i, (cx, cy, w, h) in enumerate(np.asarray(boxes_cxcywh_px).reshape(-1, 4)):
        d.rectangle([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], outline=color, width=1)
        if scores is not None:
            d.text((cx - w / 2, cy - h / 2 - 10), f"{scores[i]:.2f}", fill=color)
    if points_px is not None:
        for x, y in np.asarray(points_px).reshape(-1, 2):
            d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=point_color, width=1)
    return img


def plot_training_log(log_paths: Sequence[str], keys: Iterable[str] = ("loss",),
                      out_path: Optional[str] = None):
    """One panel per key over the epochs of JSON-lines logs (reference
    util/plot_utils.py:33-120 plot_logs); returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = list(keys)
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for path in log_paths:
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        label = os.path.basename(os.path.dirname(path)) or path
        for ax, k in zip(axes, keys):
            ys = [r[k] for r in records if k in r]
            ax.plot(range(len(ys)), ys, label=label)
            ax.set_title(k)
            ax.legend()
    if out_path:
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
    return fig

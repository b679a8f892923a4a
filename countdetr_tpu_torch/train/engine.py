"""Stage-1 pseudo-label generation (countdetr_tpu/train/engine.py
``generate_pseudo_labels``; reference 1st-stage engine.py:123-187).

    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.train.engine import generate_pseudo_labels
    model = build_model(stage1_config(compute_dtype="bfloat16"))  # on "cuda"
    generate_pseudo_labels(model, dataset, "pseudo_bbox_train.json",
                           batch_size=8, buckets=((384, 384), (384, 512), (384, 672)))

The trained point->wh regressor runs over every annotated point of every
image and the result is written as a COCO JSON whose bbox is
[cx, cy, w, h] in pixels (``"box_format": "cxcywh"``), the pseudo ground
truth stage 2 trains on. The dataset is any indexable of sample dicts
(``image`` uint8 HWC, ``points`` (k, 2) normalized cx, cy, ``orig_size``
(w, h), optional ``image_id`` and ``image_name``), as the Batcher takes it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.data.batching import Batcher, prefetch
from countdetr_tpu_torch.data.coco_io import write_coco


def point_tiers(max_points: int) -> Tuple[int, ...]:
    """The Batcher's point capacities for pseudo-labelling: every point of
    an image is kept, and a few capacities bound the distinct shapes."""
    return tuple(sorted({min(max_points, 128), max_points, max(8 * max_points, 4096)}))


def generate_pseudo_labels(
    model, dataset, out_path: str, *, batch_size: int, buckets: Sequence[Tuple[int, int]],
    max_points: int = 700, pack_s2d: bool = True, also_xywh_path: Optional[str] = None,
) -> str:
    """Run the stage-1 ``model`` over every valid point of every real image
    of ``dataset`` and write the pseudo boxes to ``out_path`` (and, with
    ``also_xywh_path``, a twin with COCO's corner-format bbox). Pixel
    values are truncated by ``int()``, as the reference does. One forward
    under inference mode and one device-to-host copy per batch."""
    batcher = Batcher(dataset, batch_size, buckets, max_points=max_points,
                      point_tiers=point_tiers(max_points), pack_s2d=pack_s2d)
    dev = next(model.parameters()).device
    images: List[Dict] = []
    annotations: List[Dict] = []
    ann_id = 1
    for batch in prefetch(iter(batcher)):
        with torch.inference_mode():
            out = model(*(torch.from_numpy(batch[k]).to(dev, non_blocking=True)
                          for k in ("images", "pad_mask", "points", "points_valid")))
            pred_wh = out["pred_wh"].cpu().numpy()  # (B, P, 2) normalized
        pts, pvalid = batch["points"], batch["points_valid"]
        for i, m in enumerate(batch["meta"]):
            if not batch["batch_valid"][i]:
                continue
            w, h = m["orig_size"]
            img_id = m.get("image_id", len(images) + 1)
            images.append({"id": img_id, "file_name": m.get("image_name", f"{img_id}.jpg"),
                           "height": int(h), "width": int(w)})
            for j in np.nonzero(pvalid[i])[0]:
                cx, cy = pts[i, j] * (w, h)
                bw, bh = pred_wh[i, j] * (w, h)
                annotations.append({
                    "id": ann_id, "image_id": img_id, "area": int(bw * bh),
                    "bbox": [int(cx), int(cy), int(bw), int(bh)],
                    "category_id": 1, "iscrowd": 0,
                })
                ann_id += 1
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_coco(out_path, images, annotations, box_format="cxcywh")
    if also_xywh_path:
        xywh = []
        for a in annotations:
            cx, cy, bw, bh = a["bbox"]
            xywh.append(dict(a, bbox=[int(cx - bw / 2), int(cy - bh / 2), int(bw), int(bh)]))
        write_coco(also_xywh_path, images, xywh, box_format="xywh")
    return out_path

"""COCO-format JSON output (countdetr_tpu/data/coco_io.py ``write_coco``).

The box format travels with the file: a top-level "box_format" key says
whether "bbox" holds [cx, cy, w, h] (the pseudo labels, as the reference
writes them, engine.py:163) or COCO's [x, y, w, h].
"""

from __future__ import annotations

import json
from typing import List, Optional


def write_coco(path: str, images: List[dict], annotations: List[dict], box_format: str,
               categories: Optional[List[dict]] = None):
    out = {
        "box_format": box_format,
        "categories": categories or [{"name": "fg", "id": 1}],
        "images": images,
        "annotations": annotations,
    }
    with open(path, "w") as f:
        json.dump(out, f)

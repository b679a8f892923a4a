"""COCO-format JSON access (countdetr_tpu/data/coco_io.py ``CocoJson`` and
``write_coco``), pure Python.

The box format travels with the file: a top-level "box_format" key says
whether "bbox" holds [cx, cy, w, h] (the pseudo labels, as the reference
writes them, engine.py:163) or COCO's [x, y, w, h]. Readers honour it and
default to cxcywh for pseudo-label files, xywh for COCO instances files.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


class CocoJson:
    """A small indexed view over a COCO-style dict or file."""

    def __init__(self, path_or_dict, default_box_format: str = "xywh"):
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = path_or_dict
        self.dataset = d
        self.box_format = d.get("box_format", default_box_format)
        self.imgs: Dict[int, dict] = {im["id"]: im for im in d.get("images", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in d.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def image_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def anns_for(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def name_to_id(self) -> Dict[str, int]:
        return {im["file_name"]: im["id"] for im in self.imgs.values()}


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

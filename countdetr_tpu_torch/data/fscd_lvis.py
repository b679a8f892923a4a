"""FSCD-LVIS dataset readers (countdetr_tpu/data/fscd_lvis.py; reference
CountDETR_lvis_1st_stage/datasets/fscd_lvis.py:11-288 and
CountDETR_lvis_2nd_stage/data/fscd_lvis.py:12-173).

Layout of a tree (the reference's):
  {data_path}/annotations/instances_{split}.json   COCO boxes of all objects
  {data_path}/annotations/count_{split}.json       exemplar boxes per image
  {data_path}/images/all_images/*.jpg
  {data_path}/annotations/pseudo_lvis_{split}_cxcywh.json  stage-1 output

Against FSCD-147: exemplars are xywh boxes in count_{split}.json (the first
3 are used), looked up by image id when the count file carries ids and by
position otherwise; images may be non-RGB (converted); the evaluation GT is
instances_{split}.json itself; the dots are the instance boxes' centres.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from countdetr_tpu_torch.data.cache import decoded_cache_from_mode
from countdetr_tpu_torch.data.coco_io import CocoJson
from countdetr_tpu_torch.data.fscd147 import load_image


def _xywh(anns) -> np.ndarray:
    return np.array([a["bbox"] for a in anns], np.float32).reshape(-1, 4)


class _LvisBase:
    """cache_mode as in data/fscd147.py::FSCD147Base."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32,
                 gt_file: Optional[str] = None, cache_mode=False):
        self._byte_cache = {} if cache_mode in (True, "bytes") else None
        self._decoded_cache = decoded_cache_from_mode(cache_mode)
        self.host_normalize: bool = True
        self.data_path = data_path
        self.split = split
        self.scale_factor = scale_factor
        self.coco = CocoJson(
            gt_file or os.path.join(data_path, "annotations", f"instances_{split}.json"), "xywh")
        with open(os.path.join(data_path, "annotations", f"count_{split}.json")) as f:
            self.count_anno = json.load(f)
        canns = self.count_anno.get("annotations", [])
        self._count_by_id = ({a["image_id"]: a for a in canns}
                             if canns and all("image_id" in a for a in canns) else None)
        self.img_dir = os.path.join(data_path, "images", "all_images")
        self.image_ids = self.coco.image_ids()

    def __len__(self):
        return len(self.image_ids)

    def _image(self, name):
        return load_image(os.path.join(self.img_dir, name), self.scale_factor,
                          byte_cache=self._byte_cache, decoded_cache=self._decoded_cache,
                          normalize=self.host_normalize)

    @staticmethod
    def _resized(info, sf):
        return sf * int(int(info["height"]) / sf), sf * int(int(info["width"]) / sf)

    def image_size(self, idx):
        """(h, w) after the resize, from the COCO height and width."""
        return self._resized(self.coco.load_img(self.image_ids[idx]), self.scale_factor)

    def num_points(self, idx) -> int:
        """Instance count (the dots are the box centres)."""
        return len(self.coco.anns_for(self.image_ids[idx]))

    def num_boxes(self, idx) -> int:
        return len(self.coco.anns_for(self.image_ids[idx]))

    def _exemplars_xywh(self, idx, img_id=None) -> np.ndarray:
        if img_id is not None and self._count_by_id is not None:
            boxes = self._count_by_id[img_id]["boxes"][:3]
        else:
            canns = self.count_anno["annotations"]
            if len(canns) != len(self.coco.image_ids()):
                raise ValueError("a count file without image ids must align one to one "
                                 "with the instances file")
            boxes = canns[idx]["boxes"][:3]
        return np.array(boxes, dtype=np.float32).reshape(-1, 4)


class FSCDLvisExemplars(_LvisBase):
    """Stage-1 training (reference FSCD_LVIS_Exemplars)."""

    def num_points(self, idx) -> int:
        return len(self._exemplars_xywh(idx, self.image_ids[idx]))

    def __getitem__(self, idx) -> Dict:
        img_id = self.image_ids[idx]
        name = self.coco.load_img(img_id)["file_name"]
        image, (w, h) = self._image(name)
        res = np.array([w, h], dtype=np.float32)
        ex = self._exemplars_xywh(idx, img_id)
        return {
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "points": ((ex[:, :2] + ex[:, 2:] / 2.0) / res).astype(np.float32),
            "whs": (ex[:, 2:] / res).astype(np.float32),
            "orig_size": (w, h),
        }


class FSCDLvisPoints(_LvisBase):
    """Pseudo-label generation: every instance's box centre as a point."""

    def __getitem__(self, idx) -> Dict:
        img_id = self.image_ids[idx]
        name = self.coco.load_img(img_id)["file_name"]
        image, (w, h) = self._image(name)
        xywh = _xywh(self.coco.anns_for(img_id))
        pts = (xywh[:, :2] + xywh[:, 2:] / 2.0) / np.array([w, h], dtype=np.float32)
        return {
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "points": pts.astype(np.float32),
            "orig_size": (w, h),
        }


class FSCDLvisEval(_LvisBase):
    """Val/test with GT boxes and exemplars clipped to the image (reference
    FSCD_LVIS_Test / FSCD_LVIS_Dataset_Test, lvis_2nd
    data/fscd_lvis.py:137-145). ``single_instances`` reads
    annotations/single_instances_{split}.json, the reference's stage-2
    test set (lvis_2nd data/fscd_lvis.py:101-103)."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32,
                 single_instances: bool = False, cache_mode=False):
        gt_file = (os.path.join(data_path, "annotations", f"single_instances_{split}.json")
                   if single_instances else None)
        super().__init__(data_path, split, scale_factor, gt_file=gt_file, cache_mode=cache_mode)

    def __getitem__(self, idx) -> Dict:
        img_id = self.image_ids[idx]
        name = self.coco.load_img(img_id)["file_name"]
        image, (w, h) = self._image(name)
        res4 = np.array([w, h, w, h], dtype=np.float32)
        xywh = _xywh(self.coco.anns_for(img_id))
        centres = xywh[:, :2] + xywh[:, 2:] / 2.0
        boxes = np.concatenate([centres, xywh[:, 2:]], axis=1) / res4
        ex = self._exemplars_xywh(idx, img_id)
        rects = np.concatenate([ex[:, :2], ex[:, :2] + ex[:, 2:]], axis=1)
        rects[:, 0::2] = np.clip(rects[:, 0::2], 0, w - 1)
        rects[:, 1::2] = np.clip(rects[:, 1::2], 0, h - 1)
        return {
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "boxes": boxes.astype(np.float32),
            "points": (centres / np.array([w, h], dtype=np.float32)).astype(np.float32),
            "exemplar_boxes": (rects / res4).astype(np.float32),
            "orig_size": (w, h),
        }


class FSCDLvisPseudo(_LvisBase):
    """Stage-2 training on stage-1 pseudo boxes (reference FSCD_LVISDataset,
    reads pseudo_lvis_{split}_cxcywh.json). The positional exemplar lookup
    uses the instances file's order, whatever the pseudo file's."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32,
                 pseudo_file: Optional[str] = None, cache_mode=False):
        super().__init__(data_path, split, scale_factor, cache_mode=cache_mode)
        pseudo_file = pseudo_file or os.path.join(data_path, "annotations",
                                                  f"pseudo_lvis_{split}_cxcywh.json")
        self.pseudo = CocoJson(pseudo_file, "cxcywh")
        self._name_to_idx = {self.coco.load_img(i)["file_name"]: k
                             for k, i in enumerate(self.coco.image_ids())}
        self.ids = self.pseudo.image_ids()
        self.image_ids = self.ids

    def image_size(self, idx):
        return self._resized(self.pseudo.load_img(self.ids[idx]), self.scale_factor)

    def num_boxes(self, idx) -> int:
        return len(self.pseudo.anns_for(self.ids[idx]))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx) -> Dict:
        img_id = self.ids[idx]
        name = self.pseudo.load_img(img_id)["file_name"]
        image, (w, h) = self._image(name)
        res4 = np.array([w, h, w, h], dtype=np.float32)
        boxes = _xywh(self.pseudo.anns_for(img_id)) / res4
        ex = self._exemplars_xywh(self._name_to_idx[name], img_id)
        rects = np.concatenate([ex[:, :2], ex[:, :2] + ex[:, 2:]], axis=1) / res4
        return {
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "boxes": boxes.astype(np.float32),
            "exemplar_boxes": rects.astype(np.float32),
            "orig_size": (w, h),
        }

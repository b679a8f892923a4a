"""Synthetic FSCD-147 tree (countdetr_tpu/data/synthetic.py
``make_synthetic_fscd147``): the same files as the real dataset, with
square "objects" drawn on a dark background, and pseudo-label files made
from the GT boxes so that stage 2 trains without a stage-1 pass. The same
arguments give the same tree as the JAX package's generator.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_fscd147(root: str, n_train: int = 32, n_val: int = 8, n_test: int = 8,
                           size=(384, 384), objects=(4, 12), seed: int = 0,
                           with_pseudo: bool = True) -> str:
    """Write the tree under ``root`` and return it. Nothing is written when
    the tree's manifest already names these arguments."""
    manifest = os.path.join(root, "synthetic_manifest.json")
    spec = {"n_train": n_train, "n_val": n_val, "n_test": n_test, "size": list(size),
            "objects": list(objects), "seed": seed, "with_pseudo": with_pseudo}
    if os.path.exists(manifest):
        with open(manifest) as f:
            if json.load(f) == spec:
                return root
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images_384_VarV2"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    H, W = size
    splits = {"train": [], "val": [], "test": []}
    annotations = {}
    img_infos = {"train": [], "val": [], "test": []}
    gt_anns = {"train": [], "val": [], "test": []}
    next_id, ann_id = 1, 1
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        for _ in range(count):
            name = f"{next_id}.jpg"
            img = rng.integers(20, 40, (H, W, 3)).astype(np.uint8)
            n_obj = int(rng.integers(objects[0], objects[1] + 1))
            pts, boxes = [], []
            ow, oh = int(rng.integers(10, 24)), int(rng.integers(8, 20))
            for _ in range(n_obj):
                cx = int(rng.integers(ow, W - ow))
                cy = int(rng.integers(oh, H - oh))
                x1, y1 = cx - ow // 2, cy - oh // 2
                img[y1:y1 + oh, x1:x1 + ow] = [200, 120, 60]
                pts.append([float(cx), float(cy)])
                boxes.append([float(x1), float(y1), float(ow), float(oh)])
            Image.fromarray(img).save(os.path.join(root, "images_384_VarV2", name), quality=95)
            ex = [[[x1, y1], [x1, y1 + h_], [x1 + w_, y1 + h_], [x1 + w_, y1]]
                  for x1, y1, w_, h_ in boxes[:3]]
            annotations[name] = {"points": pts, "box_examples_coordinates": ex}
            splits[split].append(name)
            img_infos[split].append({"id": next_id, "file_name": name, "height": H, "width": W})
            for b in boxes:
                gt_anns[split].append({"id": ann_id, "image_id": next_id, "bbox": b,
                                       "area": b[2] * b[3], "category_id": 1, "iscrowd": 0})
                ann_id += 1
            next_id += 1

    with open(os.path.join(root, "annotation_FSC147_384.json"), "w") as f:
        json.dump(annotations, f)
    with open(os.path.join(root, "Train_Test_Val_FSC_147.json"), "w") as f:
        json.dump(splits, f)
    categories = [{"name": "fg", "id": 1}]
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"instances_{split}.json"), "w") as f:
            json.dump({"images": img_infos[split], "annotations": gt_anns[split],
                       "categories": categories}, f)
        if with_pseudo:
            # the GT boxes in the pseudo-label contract: cxcywh in a COCO bbox
            pseudo = [{**a, "bbox": [a["bbox"][0] + a["bbox"][2] / 2.0,
                                     a["bbox"][1] + a["bbox"][3] / 2.0,
                                     a["bbox"][2], a["bbox"][3]]} for a in gt_anns[split]]
            with open(os.path.join(root, "annotations", f"pseudo_bbox_{split}.json"), "w") as f:
                json.dump({"images": img_infos[split], "annotations": pseudo,
                           "categories": categories, "box_format": "cxcywh"}, f)
    with open(manifest, "w") as f:
        json.dump(spec, f)
    return root

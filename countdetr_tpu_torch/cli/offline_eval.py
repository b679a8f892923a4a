"""The offline evaluator (countdetr_tpu/cli/offline_eval.py; reference
CountDETR_147_2nd_stage/eval_all.py:44-578 and
offline_{coco,lvis}_evaluator.py).

Reads a predictions JSON (cxcywh pixel boxes, as engine.infer_detections
writes it) with the GT instances and, for FSCD-147, the dot annotations,
and reports detection AP (maxDets 900, 1000, 1100) with the counting
metrics MAE, RMSE, NAE and SRE (and MRE for FSCD-LVIS). Host numpy only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from countdetr_tpu_torch.data.coco_io import CocoJson
from countdetr_tpu_torch.eval.coco_eval import CocoEvaluator
from countdetr_tpu_torch.eval.counting import counting_metrics

MAX_DETS = (900, 1000, 1100)


def _to_xywh(bbox, fmt: str):
    x, y, w, h = bbox
    if fmt == "cxcywh":
        return [x - w / 2.0, y - h / 2.0, w, h]
    return [x, y, w, h]


def _cxcywh_to_xywh(b: np.ndarray) -> np.ndarray:
    return np.concatenate([b[:, :2] - b[:, 2:] / 2.0, b[:, 2:]], axis=1)


def evaluate_predictions(pred_path: str, data_path: str, dataset: str = "fscd_147",
                         split: str = "test", gt_file: Optional[str] = None) -> Dict[str, float]:
    """AP and counting metrics of a predictions file against a split.

    fscd_147: GT boxes from {data_path}/instances_{split}.json; the GT count
    is the image's number of dots in annotation_FSC147_384.json.
    fscd_lvis: GT boxes from {data_path}/annotations/instances_{split}.json,
    every class as the one foreground class; the GT count is the image's
    number of GT boxes (images without any are not counted)."""
    preds = CocoJson(pred_path, "cxcywh")
    lvis = dataset == "fscd_lvis"
    if gt_file is None:
        gt_file = (os.path.join(data_path, "annotations", f"instances_{split}.json") if lvis
                   else os.path.join(data_path, f"instances_{split}.json"))
    gt = CocoJson(gt_file, "xywh")
    point_annos: Dict = {}
    if not lvis:
        with open(os.path.join(data_path, "annotation_FSC147_384.json")) as f:
            point_annos = json.load(f)

    ev = CocoEvaluator(max_dets=MAX_DETS)
    gt_counts: List[int] = []
    pred_counts: List[int] = []
    id2name = {im["id"]: im["file_name"] for im in gt.dataset["images"]}
    for img_id in preds.image_ids():
        anns = preds.anns_for(img_id)
        dets = np.array([_to_xywh(a["bbox"], preds.box_format) for a in anns],
                        np.float64).reshape(-1, 4)
        scores = np.array([a.get("score", 1.0) for a in anns], np.float64)
        gt_anns = gt.anns_for(img_id)
        gts = np.array([_to_xywh(a["bbox"], gt.box_format) for a in gt_anns],
                       np.float64).reshape(-1, 4)
        crowd = np.array([bool(a.get("iscrowd", 0)) for a in gt_anns], dtype=bool)
        ev.add_image(dets, scores, gts, gt_iscrowd=crowd)
        if lvis:
            if len(gt_anns):
                gt_counts.append(len(gt_anns))
                pred_counts.append(len(anns))
        else:
            name = id2name.get(img_id) or preds.load_img(img_id).get("file_name")
            if name in point_annos:
                gt_counts.append(len(point_annos[name]["points"]))
                pred_counts.append(len(anns))
    out = ev.summarize()
    if gt_counts:
        out.update(counting_metrics(gt_counts, pred_counts))
    return out


def _gt_xywh_by_name(dataset) -> Dict:
    """Pixel xywh GT boxes per image name, from the dataset's COCO GT
    (``FSCD147Eval.gt``, ``FSCDLvisEval.coco``: no image decoded), else
    from its samples."""
    coco = getattr(dataset, "gt", None) or getattr(dataset, "coco", None)
    if coco is not None:
        out = {}
        for img_id in coco.image_ids():
            b = np.array([a["bbox"] for a in coco.anns_for(img_id)], np.float64).reshape(-1, 4)
            if coco.box_format == "cxcywh":
                b = _cxcywh_to_xywh(b)
            out[coco.load_img(img_id)["file_name"]] = b
        return out
    by_name = {}
    for i in range(len(dataset)):
        s = dataset[i]
        w, h = s["orig_size"]
        by_name[s.get("image_name", i)] = _cxcywh_to_xywh(
            s["boxes"] * np.array([w, h, w, h], np.float32))
    return by_name


def evaluate_results(results: List[Dict], dataset, by_name=None) -> Dict[str, float]:
    """AP of engine.infer_detections' results against an eval dataset's GT
    (``by_name``: a prebuilt ``_gt_xywh_by_name(dataset)``)."""
    by_name = by_name if by_name is not None else _gt_xywh_by_name(dataset)
    ev = CocoEvaluator(max_dets=MAX_DETS)
    for r in results:
        gts = by_name.get(r.get("image_name"))
        if gts is None:
            continue
        xywh = _cxcywh_to_xywh(np.asarray(r["boxes_cxcywh_px"], np.float64).reshape(-1, 4))
        ev.add_image(xywh, np.asarray(r["scores"]), gts)
    return ev.summarize()


def per_image_ap(results: List[Dict], dataset, by_name=None) -> Dict[str, Dict[str, float]]:
    """AP and AP50 of each image as its own COCO run (the reference's
    cal_ap, evaluate_val_and_test.py:27-135)."""
    by_name = by_name if by_name is not None else _gt_xywh_by_name(dataset)
    out: Dict[str, Dict[str, float]] = {}
    for r in results:
        gts = by_name.get(r.get("image_name"))
        if gts is None:
            continue
        xywh = _cxcywh_to_xywh(np.asarray(r["boxes_cxcywh_px"], np.float64).reshape(-1, 4))
        ev = CocoEvaluator(max_dets=MAX_DETS)
        ev.add_image(xywh, np.asarray(r["scores"]), gts)
        s = ev.summarize()
        out[r["image_name"]] = {"AP": s["AP"], "AP50": s["AP50"]}
    return out


def analyze_results(results, out_dir: str = "", worst_k: int = 20, image_aps=None):
    """Per-image results sorted by |count error| (reference
    scripts/analyze_res.py:10-54); with ``out_dir``, writes all of them to
    each_img_info.json and the ``worst_k`` worst to worst_images.json.
    ``image_aps`` (per_image_ap's) adds AP columns. Returns the worst."""
    image_aps = image_aps or {}
    scored = [{
        "image_name": r.get("image_name"),
        "image_id": r.get("image_id"),
        "count_gt": r.get("count_gt"),
        "count_pred": r.get("count_pred"),
        "abs_err": abs((r.get("count_gt") or 0) - r["count_pred"]),
        **image_aps.get(r.get("image_name"), {}),
    } for r in results]
    scored.sort(key=lambda x: -x["abs_err"])
    worst = scored[:worst_k]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "each_img_info.json"), "w") as f:
            json.dump(scored, f, indent=2)
        with open(os.path.join(out_dir, "worst_images.json"), "w") as f:
            json.dump(worst, f, indent=2)
    return worst


def visualize_predictions(pred_path: str, data_path: str, out_dir: str, limit: int = 20,
                          image_dir: str = "images_384_VarV2") -> int:
    """Draw the predicted boxes (and anchor points) of up to ``limit``
    images into ``out_dir`` (reference scripts/visualize_generated_data.py);
    returns how many were drawn."""
    from PIL import Image

    from countdetr_tpu_torch.utils.visualize import draw_detections

    preds = CocoJson(pred_path, "cxcywh")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for img_id in preds.image_ids():
        if count >= limit:
            break
        name = preds.load_img(img_id).get("file_name")
        path = os.path.join(data_path, image_dir, name or "")
        if not name or not os.path.exists(path):
            continue
        anns = preds.anns_for(img_id)
        boxes = np.array([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        if preds.box_format == "xywh":
            boxes = np.concatenate([boxes[:, :2] + boxes[:, 2:] / 2.0, boxes[:, 2:]], axis=1)
        scores = np.array([a.get("score", 1.0) for a in anns])
        pts = np.array([a["point"] for a in anns if "point" in a], np.float32).reshape(-1, 2)
        with Image.open(path) as im:
            img = draw_detections(im, boxes, pts if len(pts) else None, scores)
        img.save(os.path.join(out_dir, name))
        count += 1
    return count

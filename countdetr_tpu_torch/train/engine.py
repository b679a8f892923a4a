"""The host-side engine: epoch loops, evaluation, pseudo-labels and
inference (countdetr_tpu/train/engine.py; reference 1st-stage
engine.py:27-265, 2nd-stage engine.py:14-175).

    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.data.fscd147 import FSC147Pseudo, FSCD147Eval
    from countdetr_tpu_torch.train import checkpoints, engine
    from countdetr_tpu_torch.train.train_step import Trainer
    ds = FSC147Pseudo(root, "train"); ds.host_normalize = False
    batcher = Batcher(ds, 8, buckets, box_tiers=(128, 700, 5600), shuffle=True,
                      num_workers=2, pack_s2d=True)
    trainer = Trainer(stage2_config(compute_dtype="bfloat16"), TrainConfig(),
                      steps_per_epoch=batcher.num_batches())  # on "cuda"
    saver = checkpoints.AsyncSaver()
    for epoch in range(epochs):
        stats = engine.train_one_epoch(trainer, batcher, epoch)
        saver.save(out_dir, epoch, trainer, {"epoch": epoch})
    saver.finalize()
    results = engine.infer_detections(trainer.model, FSCD147Eval(root, "test"),
                                      "predictions_test.json", batch_size=8, buckets=buckets)

Batches stream from the Batcher through a prefetch thread. A train step
queues its work on the card and returns; the host reads the card only when
the metric logger prints and when the NaN guard reads ``Trainer.bad_steps``
(every ``min(10, log_every)`` steps and once at the end of the epoch).
The inference loops take the model and run it under inference mode, one
forward and one device-to-host copy per batch. No loop reads masks (nor
does the JAX engine), so their forwards skip a ``masks`` model's mask head.
The dataset of a loop is any indexable of sample dicts, as the Batcher
takes it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.data.batching import Batcher, prefetch, unpack_space_to_depth
from countdetr_tpu_torch.data.coco_io import write_coco
from countdetr_tpu_torch.eval.counting import counting_metrics
from countdetr_tpu_torch.eval.postprocess import adaptive_threshold_counting, topk_postprocess
from countdetr_tpu_torch.utils.logging import MetricLogger


def _real(batch: Dict) -> int:
    bv = batch.get("batch_valid")
    return int(np.asarray(bv).sum()) if bv is not None else len(batch["images"])


def train_one_epoch(trainer, batcher, epoch: int, log_every: int = 100,
                    prefetch_depth: int = 2, max_steps: Optional[int] = None) -> Dict:
    """One epoch of ``trainer.step`` over the batcher's batches. Returns the
    logger's means (over the printed steps) with ``epoch``, ``steps`` and
    ``real_samples``. Raises FloatingPointError when a loss was not finite:
    the step counts it in ``trainer.bad_steps`` on the card, read every
    ``min(10, log_every)`` steps and after the last (the reference stops on
    the first, engine.py:64-67, at a sync a step)."""
    logger = MetricLogger(print_every=log_every, prefix=f"Epoch [{epoch}] ")
    check_every = max(1, min(10, log_every))

    def check_bad():
        if int(trainer.bad_steps) > 0:
            raise FloatingPointError(f"non-finite loss at epoch {epoch}")

    n_steps = n_real = 0
    for batch in prefetch(iter(batcher), depth=prefetch_depth):
        batch.pop("meta", None)
        batch.pop("bucket", None)
        n_real += _real(batch)
        metrics = trainer.step(batch)
        n_steps += 1
        if n_steps % check_every == 0:
            check_bad()
        logger.step(metrics)
        if max_steps is not None and n_steps >= max_steps:
            break  # the prefetch thread stays parked on its full queue
    if n_steps:
        check_bad()
    stats = logger.summary()
    stats.update(epoch=epoch, steps=n_steps, real_samples=n_real)
    return stats


def evaluate(trainer, batcher) -> Dict:
    """The losses of ``trainer.eval_step`` over the batcher, every step
    read; the means with ``real_samples``."""
    logger = MetricLogger(print_every=50, prefix="Eval ")
    n_real = 0
    for batch in prefetch(iter(batcher)):
        batch.pop("meta", None)
        batch.pop("bucket", None)
        n_real += _real(batch)
        logger.step(trainer.eval_step(batch), force=True)
    stats = logger.summary()
    stats["real_samples"] = n_real
    return stats


def _inputs(model, batch: Dict, keys) -> List[torch.Tensor]:
    dev = next(model.parameters()).device
    return [torch.from_numpy(batch[k]).to(dev, non_blocking=True) for k in keys]


def point_tiers(max_points: int) -> Tuple[int, ...]:
    """The Batcher's point capacities for pseudo-labelling: every point of
    an image is kept, and a few capacities bound the distinct shapes."""
    return tuple(sorted({min(max_points, 128), max_points, max(8 * max_points, 4096)}))


def generate_pseudo_labels(
    model, dataset, out_path: str, *, batch_size: int, buckets: Sequence[Tuple[int, int]],
    max_points: int = 700, num_workers: int = 0, pack_s2d: bool = True,
    also_xywh_path: Optional[str] = None,
) -> str:
    """Run the stage-1 ``model`` over every valid point of every real image
    and write the pseudo boxes to ``out_path`` as a COCO JSON whose bbox is
    [cx, cy, w, h] in pixels (``"box_format": "cxcywh"``; reference
    1st-stage engine.py:123-187), and with ``also_xywh_path`` a twin with
    COCO's corner bbox. Pixel values are truncated by ``int()``, as the
    reference does."""
    batcher = Batcher(dataset, batch_size, buckets, max_points=max_points,
                      point_tiers=point_tiers(max_points), num_workers=num_workers,
                      pack_s2d=pack_s2d)
    images: List[Dict] = []
    annotations: List[Dict] = []
    ann_id = 1
    try:
        for batch in prefetch(iter(batcher)):
            with torch.inference_mode():
                out = model(*_inputs(model, batch, ("images", "pad_mask", "points",
                                                    "points_valid")), masks=False)
                pred_wh = out["pred_wh"].float().cpu().numpy()  # (B, P, 2) normalized
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
    finally:
        batcher.close()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_coco(out_path, images, annotations, box_format="cxcywh")
    if also_xywh_path:
        xywh = []
        for a in annotations:
            cx, cy, bw, bh = a["bbox"]
            xywh.append(dict(a, bbox=[int(cx - bw / 2), int(cy - bh / 2), int(bw), int(bh)]))
        write_coco(also_xywh_path, images, xywh, box_format="xywh")
    return out_path


def infer_detections(
    model, dataset, out_path: Optional[str], *, batch_size: int,
    buckets: Sequence[Tuple[int, int]], max_boxes: int = 700, max_points: int = 700,
    num_workers: int = 0, pack_s2d: bool = True,
) -> List[Dict]:
    """Stage-2 inference with the adaptive-threshold count (reference
    2nd-stage engine.py:70-175). Returns one result per real image
    (``count_pred``, ``count_gt`` from the untruncated dot count,
    ``threshold``, kept ``boxes_cxcywh_px`` and ``scores``) and, with
    ``out_path``, writes the predictions as a COCO JSON (cxcywh pixels, a
    score and an anchor point per box). Under the sampled prior the
    batches' ``sampled_points`` are the anchors; a dataset that emits none
    raises ValueError, as in the JAX package."""
    batcher = Batcher(dataset, batch_size, buckets, max_points=max_points, max_boxes=max_boxes,
                      num_workers=num_workers, pack_s2d=pack_s2d)
    images: List[Dict] = []
    annotations: List[Dict] = []
    results: List[Dict] = []
    ann_id = 1
    try:
        for batch in prefetch(iter(batcher)):
            keys = ("images", "pad_mask", "exemplar_boxes")
            if "sampled_points" in batch:
                keys += ("sampled_points", "sampled_points_valid")
            elif model.cfg.spatial_prior == "sampled":
                raise ValueError(
                    "spatial_prior='sampled' but the dataset emitted no 'sampled_points': use "
                    "an FSCD-147 eval or pseudo dataset with num_sampled_points > 0")
            with torch.inference_mode():
                out = model(*_inputs(model, batch, keys), aux_outputs=False, masks=False)
                logits, boxes, refs = (out[k].float().cpu().numpy() for k in
                                       ("pred_logits", "pred_boxes", "reference_points"))
            pts_valid = batch.get("points_valid")
            prob = 1.0 / (1.0 + np.exp(-logits[..., 0]))  # class-0 sigmoid
            for i, m in enumerate(batch["meta"]):
                if not batch["batch_valid"][i]:
                    continue
                w, h = m["orig_size"]
                keep, thr = adaptive_threshold_counting(prob[i])
                img_id = m.get("image_id", len(images) + 1)
                images.append({"id": img_id, "file_name": m.get("image_name", "None"),
                               "height": int(h), "width": int(w)})
                kept_boxes = boxes[i][keep] * (w, h, w, h)
                kept_scores = prob[i][keep]
                for s, b, r in zip(kept_scores, kept_boxes, refs[i][keep] * (w, h)):
                    annotations.append({
                        "id": ann_id, "image_id": img_id, "area": int(b[2] * b[3]),
                        "bbox": [int(b[0]), int(b[1]), int(b[2]), int(b[3])],
                        "category_id": 1, "score": float(s), "point": [int(r[0]), int(r[1])],
                    })
                    ann_id += 1
                results.append({
                    "image_id": img_id,
                    "image_name": m.get("image_name"),
                    "count_pred": int(keep.sum()),
                    # the untruncated dot count, not the padded points_valid sum
                    "count_gt": (int(m["n_points"]) if m.get("n_points") else
                                 (int(pts_valid[i].sum()) if pts_valid is not None else None)),
                    "threshold": thr,
                    "boxes_cxcywh_px": kept_boxes,
                    "scores": kept_scores,
                })
    finally:
        batcher.close()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_coco(out_path, images, annotations, box_format="cxcywh")
    return results


def counting_summary(results: List[Dict]) -> Dict[str, float]:
    """Counting metrics over the results that carry a GT count."""
    gts = [r["count_gt"] for r in results if r["count_gt"] is not None]
    preds = [r["count_pred"] for r in results if r["count_gt"] is not None]
    return counting_metrics(gts, preds) if gts else {}


def stage1_test(
    model, dataset, out_path: Optional[str], *, batch_size: int,
    buckets: Sequence[Tuple[int, int]], max_points: int = 700, max_boxes: int = 700,
    num_workers: int = 0, pack_s2d: bool = True, vis_dir: Optional[str] = None,
) -> Optional[str]:
    """Stage-1 test mode (reference 1st-stage engine.py:190-265): the
    point->wh model on the dots, the top 100 (query, class) scores of each
    image written as xywh COCO boxes in pixels; with ``vis_dir``, each
    image with its boxes drawn."""
    batcher = Batcher(dataset, batch_size, buckets, max_points=max_points, max_boxes=max_boxes,
                      num_workers=num_workers, pack_s2d=pack_s2d)
    images: List[Dict] = []
    annotations: List[Dict] = []
    ann_id = 1
    try:
        for batch in prefetch(iter(batcher)):
            meta = batch["meta"]
            with torch.inference_mode():
                out = model(*_inputs(model, batch, ("images", "pad_mask", "points",
                                                    "points_valid")), masks=False)
                logits = out["pred_logits"].float()
                boxes_cxcywh = torch.cat([out["pred_points"], out["pred_wh"]], -1).float()
                sizes = torch.tensor([[m["orig_size"][1], m["orig_size"][0]] for m in meta],
                                     dtype=torch.float32, device=logits.device)  # (h, w)
                k = min(100, logits.shape[1] * logits.shape[2])
                post_boxes = topk_postprocess(logits, boxes_cxcywh, sizes, k=k)["boxes"]
                post_boxes = post_boxes.cpu().numpy()  # (B, k, 4) xyxy pixels
            for i, m in enumerate(meta):
                if not batch["batch_valid"][i]:
                    continue
                w, h = m["orig_size"]
                img_id = m.get("image_id", len(images) + 1)
                images.append({"id": img_id, "file_name": m.get("image_name", "None"),
                               "height": int(h), "width": int(w)})
                bxs = post_boxes[i]
                for x1, y1, x2, y2 in bxs:
                    annotations.append({
                        "id": ann_id, "image_id": img_id, "area": int((x2 - x1) * (y2 - y1)),
                        "bbox": [int(x1), int(y1), int(x2 - x1), int(y2 - y1)],
                        "category_id": 1, "iscrowd": 0,
                    })
                    ann_id += 1
                if vis_dir:
                    _draw_stage1(batch, i, bxs, (w, h),
                                 os.path.join(vis_dir, m.get("image_name", f"{img_id}.jpg")))
    finally:
        batcher.close()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_coco(out_path, images, annotations, box_format="xywh")
    return out_path


def _draw_stage1(batch: Dict, i: int, bxs: np.ndarray, orig_size, path: str):
    """Image i of the batch, cut to its content (the pad mask) and
    de-normalized, with the xyxy pixel boxes ``bxs`` of the original image
    scaled onto it."""
    from countdetr_tpu_torch.data.fscd147 import IMAGENET_MEAN, IMAGENET_STD
    from countdetr_tpu_torch.utils.visualize import draw_detections

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = np.asarray(batch["images"][i])
    if img.shape[-1] == 12:  # the packed pipe
        img = unpack_space_to_depth(img[None])[0]
    pm = np.asarray(batch["pad_mask"][i])
    rh, rw = int((~pm).any(axis=1).sum()), int((~pm).any(axis=0).sum())
    if img.dtype == np.uint8:
        img = img[:rh, :rw].astype(np.float32)
    else:
        img = (img[:rh, :rw] * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    w, h = orig_size
    cxcywh = np.stack([(bxs[:, 0] + bxs[:, 2]) / 2 * rw / w, (bxs[:, 1] + bxs[:, 3]) / 2 * rh / h,
                       (bxs[:, 2] - bxs[:, 0]) * rw / w, (bxs[:, 3] - bxs[:, 1]) * rh / h], axis=1)
    draw_detections(np.clip(img, 0, 255), cxcywh).save(path)

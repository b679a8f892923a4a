"""Stage-2 counting inference: image + 3 exemplar boxes in, detections and a
count out. The inference half of countdetr_tpu/train/engine.py
(``infer_detections``), without datasets or COCO files.

    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.serve import Predictor
    pred = Predictor(stage2_config(compute_dtype="bfloat16"))  # on "cuda"
    results = pred.predict([(image_uint8_hwc, boxes_3x4_xyxy_normalized)])

Each request is padded into the bucket (pad mask included), the batch is
space-to-depth packed and run through one forward; each request gets
``count``, ``threshold``, ``boxes_cxcywh_px`` and ``scores``. A call is one
``serve.predict`` span around ``serve.pack``, ``serve.h2d``,
``serve.model``, ``serve.d2h`` and ``serve.count``; ``pack_requests``
counts ``serve.px_real`` and ``serve.px_bucket`` (``utils/trace.py``). Under the
learned and grid priors a request is (image, boxes); under the sampled and
defined priors it carries its anchors too, (image, boxes, points (S, 2)
normalized x, y), padded to the batch's longest with a validity mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.data.batching import fit_to_bucket, pack_space_to_depth, pad_to_bucket
from countdetr_tpu_torch.eval.postprocess import adaptive_threshold_counting
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.utils import trace

POINTS_PRIORS = ("defined", "sampled")


def pack_requests(requests: Sequence[Tuple[np.ndarray, ...]], bucket: Tuple[int, int]):
    """Host-side batch of (uint8 HWC image, (K, 4) normalized xyxy boxes,
    ...) requests: (packed uint8 (B, H/2, W/2, 12), pad_mask (B, H, W),
    exemplar boxes (B, K, 4) float32, original (w, h) per request). Counts
    the pixels the images keep (after any downscale) and the buckets'."""
    images, masks, rects, sizes = [], [], [], []
    for image, boxes, *_ in requests:
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"request image must be uint8 HWC RGB, got "
                             f"{image.dtype} {image.shape}")
        padded, mask = pad_to_bucket(image, bucket)
        images.append(padded)
        masks.append(mask)
        rects.append(np.asarray(boxes, dtype=np.float32).reshape(-1, 4))
        sizes.append((image.shape[1], image.shape[0]))
        h, w = fit_to_bucket(*image.shape[:2], bucket)
        trace.count("serve.px_real", h * w)
    trace.count("serve.px_bucket", len(requests) * bucket[0] * bucket[1])
    return pack_space_to_depth(np.stack(images)), np.stack(masks), np.stack(rects), sizes


def pack_points(requests: Sequence[Tuple[np.ndarray, ...]]) -> Tuple[np.ndarray, np.ndarray]:
    """The requests' anchor points (their third element, (S_i, 2)), padded
    to the longest: (points (B, S, 2) float32, points_valid (B, S) bool)."""
    pts = [np.asarray(r[2], dtype=np.float32).reshape(-1, 2) for r in requests]
    S = max(len(p) for p in pts)
    points = np.zeros((len(pts), S, 2), np.float32)
    valid = np.zeros((len(pts), S), bool)
    for i, p in enumerate(pts):
        points[i, :len(p)] = p
        valid[i, :len(p)] = True
    return points, valid


class Predictor:
    """Serves a stage-2 CountingDetr under any of its priors. Weights come
    from ``state_dict`` or, without one, from ``seed``."""

    def __init__(self, cfg: ModelConfig, state_dict: Optional[dict] = None,
                 device="cuda", bucket: Tuple[int, int] = (592, 592), seed: int = 0):
        self.model = build_model(cfg, device=device, seed=seed, state_dict=state_dict)
        self.device = next(self.model.parameters()).device
        self.bucket = tuple(bucket)

    @torch.inference_mode()
    def forward(self, images: np.ndarray, pad_mask: np.ndarray, exemplar_boxes: np.ndarray,
                points: Optional[np.ndarray] = None,
                points_valid: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """One forward of a packed batch on the predictor's device (the
        points for the sampled and defined priors); with the mask head, its
        ``pred_masks`` (B, L, H/4, W/4) logits too."""
        dev = self.device
        arrays = [images, pad_mask, exemplar_boxes]
        if points is not None:
            arrays += [points, points_valid]
        with trace.span("serve.h2d"):
            inputs = [torch.from_numpy(a).to(dev, non_blocking=True) for a in arrays]
        with trace.span("serve.model"):
            return self.model(*inputs, aux_outputs=False)

    def predict(self, requests: Sequence[Tuple[np.ndarray, ...]]) -> List[Dict]:
        with trace.span("serve.predict"):
            return self._predict(requests)

    def _predict(self, requests: Sequence[Tuple[np.ndarray, ...]]) -> List[Dict]:
        points = valid = None
        prior = self.model.cfg.spatial_prior
        with trace.span("serve.pack"):
            images, masks, rects, sizes = pack_requests(requests, self.bucket)
            if prior in POINTS_PRIORS:
                if any(len(r) < 3 for r in requests):
                    raise ValueError(f"the {prior} prior takes (image, boxes, points) requests")
                points, valid = pack_points(requests)
        out = self.forward(images, masks, rects, points, valid)
        with trace.span("serve.d2h"):
            logits = out["pred_logits"].cpu().numpy()
            boxes = out["pred_boxes"].cpu().numpy()
        with trace.span("serve.count"):
            prob = 1.0 / (1.0 + np.exp(-logits[..., 0]))  # class-0 sigmoid
            results = []
            for i, (w, h) in enumerate(sizes):
                keep, thr = adaptive_threshold_counting(prob[i])
                results.append({
                    "count": int(keep.sum()),
                    "threshold": thr,
                    "boxes_cxcywh_px": boxes[i][keep] * (w, h, w, h),
                    "scores": prob[i][keep],
                })
        return results

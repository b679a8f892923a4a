"""Stage-2 counting inference: image + 3 exemplar boxes in, detections and a
count out. The inference half of countdetr_tpu/train/engine.py
(``infer_detections``), without datasets or COCO files.

    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.serve import Predictor
    pred = Predictor(stage2_config(compute_dtype="bfloat16"))  # on "cuda"
    results = pred.predict([(image_uint8_hwc, boxes_3x4_xyxy_normalized)])

Each request is padded into the bucket (pad mask included), the batch is
space-to-depth packed and run through one forward; each request gets
``count``, ``threshold``, ``boxes_cxcywh_px`` and ``scores``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.data.batching import pack_space_to_depth, pad_to_bucket
from countdetr_tpu_torch.eval.postprocess import adaptive_threshold_counting
from countdetr_tpu_torch.models.anchor_detr import build_model


def pack_requests(requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                  bucket: Tuple[int, int]):
    """Host-side batch of (uint8 HWC image, (K, 4) normalized xyxy boxes)
    requests: (packed uint8 (B, H/2, W/2, 12), pad_mask (B, H, W), exemplar
    boxes (B, K, 4) float32, original (w, h) per request)."""
    images, masks, rects, sizes = [], [], [], []
    for image, boxes in requests:
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"request image must be uint8 HWC RGB, got "
                             f"{image.dtype} {image.shape}")
        padded, mask = pad_to_bucket(image, bucket)
        images.append(padded)
        masks.append(mask)
        rects.append(np.asarray(boxes, dtype=np.float32).reshape(-1, 4))
        sizes.append((image.shape[1], image.shape[0]))
    return pack_space_to_depth(np.stack(images)), np.stack(masks), np.stack(rects), sizes


class Predictor:
    """Serves a stage-2 CountingDetr. Weights come from ``state_dict`` or,
    without one, from ``seed``."""

    def __init__(self, cfg: ModelConfig, state_dict: Optional[dict] = None,
                 device="cuda", bucket: Tuple[int, int] = (592, 592), seed: int = 0):
        self.model = build_model(cfg, device=device, seed=seed, state_dict=state_dict)
        self.device = next(self.model.parameters()).device
        self.bucket = tuple(bucket)

    @torch.inference_mode()
    def forward(self, images: np.ndarray, pad_mask: np.ndarray,
                exemplar_boxes: np.ndarray) -> Dict[str, torch.Tensor]:
        """One forward of a packed batch on the predictor's device."""
        dev = self.device
        return self.model(
            torch.from_numpy(images).to(dev, non_blocking=True),
            torch.from_numpy(pad_mask).to(dev, non_blocking=True),
            torch.from_numpy(exemplar_boxes).to(dev, non_blocking=True),
        )

    def predict(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]]) -> List[Dict]:
        images, masks, rects, sizes = pack_requests(requests, self.bucket)
        out = self.forward(images, masks, rects)
        logits = out["pred_logits"].cpu().numpy()
        boxes = out["pred_boxes"].cpu().numpy()
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

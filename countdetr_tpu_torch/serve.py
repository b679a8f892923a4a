"""Inference of either stage: a request's image (with the exemplar boxes of
stage 2) in, its detections out. The inference half of
countdetr_tpu/train/engine.py (``infer_detections``), without datasets or
COCO files.

    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.serve import Predictor
    pred = Predictor(stage2_config(compute_dtype="bfloat16"))  # on "cuda"
    results = pred.predict([(image_uint8_hwc, boxes_3x4_xyxy_normalized)])

A stage-2 model (exemplar aggregation) counts: each request is (image,
boxes) and gets ``count``, ``threshold``, ``boxes_cxcywh_px`` and ``scores``
(the counting rule). A stage-1 model is served as the detector it is
(Anchor DETR): each request is (image,) and gets the top 100 of its
queries x classes sigmoid scores (``topk_postprocess``, the reference's
``PostProcess``): ``scores``, ``labels`` and ``boxes_xyxy_px`` at the
image's own size, the boxes being ``pred_points`` and ``pred_wh`` as cxcywh.

    pred = Predictor(ModelConfig(num_classes=91), bucket=((800, 1344), (1344, 800)))
    results = pred.predict([(image_uint8_hwc,)])

A predictor holds one bucket or several; a call goes into the smallest
that holds every one of its images (of equal areas, the first listed), or,
where none does, into the largest, its larger images downscaled to fit. A
call stages its requests' raw images back to back, with their boxes and a
table of offsets and sizes, in one buffer of the predictor's (pinned on a
card; ``stage_requests``), copies the used part to the device in one copy,
and there pads, masks and space-to-depth packs them in one kernel launch
(``ops/kernels/pack_kernel.py``); one forward follows. A call is one
``serve.predict`` span around ``serve.pack`` (the staging), ``serve.h2d``
(the copy and the pack launch), ``serve.model``, then stage 2's
``serve.d2h`` and ``serve.count`` or stage 1's ``serve.topk``; staging
counts ``serve.px_real``, ``serve.px_bucket`` and ``serve.pack_resized``
(``utils/trace.py``). ``pack_requests`` is the same pack on the host, in
numpy, for callers of ``Predictor.forward``. Under the learned and grid
priors a request is as above; under stage 2's sampled and defined priors it
carries its anchors too, (image, boxes, points (S, 2) normalized x, y),
padded to the batch's longest with a validity mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.data.batching import (_resize_bilinear, fit_to_bucket,
                                               pack_space_to_depth, pad_to_bucket)
from countdetr_tpu_torch.eval.postprocess import adaptive_threshold_counting, topk_postprocess
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.ops.kernels import pack_kernel
from countdetr_tpu_torch.utils import trace

POINTS_PRIORS = ("defined", "sampled")
TOPK = 100  # detections a stage-1 request gets (the reference's PostProcess)
ALIGN = 16  # bytes: every section and image of the staging buffer starts on a multiple


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _check_image(image: np.ndarray):
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"request image must be uint8 HWC RGB, got "
                         f"{image.dtype} {image.shape}")


def request_boxes(requests: Sequence[Tuple[np.ndarray, ...]], exemplars: bool = True
                  ) -> np.ndarray:
    """The requests' exemplar boxes, (B, K, 4) float32; (B, 0, 4) for a
    model that takes none (``exemplars`` False)."""
    if not exemplars:
        return np.zeros((len(requests), 0, 4), np.float32)
    return np.stack([np.asarray(boxes, dtype=np.float32).reshape(-1, 4)
                     for _, boxes, *_ in requests])


def pick_bucket(sizes: Sequence[Tuple[int, int]], buckets: Sequence[Tuple[int, int]]
                ) -> Tuple[int, int]:
    """The smallest of ``buckets`` (by area; of equal areas the first) that
    holds every (h, w) of ``sizes``, else the largest."""
    fits = [b for b in buckets if all(h <= b[0] and w <= b[1] for h, w in sizes)]
    if fits:
        return min(fits, key=lambda b: b[0] * b[1])
    return max(buckets, key=lambda b: b[0] * b[1])


def pack_requests(requests: Sequence[Tuple[np.ndarray, ...]], bucket: Tuple[int, int]):
    """Host-side batch of (uint8 HWC image, (K, 4) normalized xyxy boxes,
    ...) requests: (packed uint8 (B, H/2, W/2, 12), pad_mask (B, H, W),
    exemplar boxes (B, K, 4) float32, original (w, h) per request). Counts
    the pixels the images keep (after any downscale) and the buckets'."""
    images, masks, sizes = [], [], []
    for image, *_ in requests:
        _check_image(image)
        padded, mask = pad_to_bucket(image, bucket)
        images.append(padded)
        masks.append(mask)
        sizes.append((image.shape[1], image.shape[0]))
        h, w = fit_to_bucket(*image.shape[:2], bucket)
        trace.count("serve.px_real", h * w)
    trace.count("serve.px_bucket", len(requests) * bucket[0] * bucket[1])
    return pack_space_to_depth(np.stack(images)), np.stack(masks), request_boxes(requests), sizes


def staging_layout(B: int, K: int, bucket: Tuple[int, int]) -> Tuple[int, int, int]:
    """(byte offset of the boxes, of the first image, the most bytes any B
    requests of K boxes take) in a staging buffer: the (B, 3) int64 table
    at 0, the (B, K, 4) float32 boxes (none where K = 0), then each image,
    every one at an ALIGN-byte offset."""
    boxes_at = _aligned(24 * B)
    images_at = boxes_at + 16 * B * K
    return boxes_at, images_at, images_at + B * _aligned(bucket[0] * bucket[1] * 3)


def staged_views(buf: torch.Tensor, B: int, K: int, bucket: Tuple[int, int]):
    """The (B, 3) int64 table of (byte offset, h, w) and the (B, K, 4)
    float32 boxes inside a staging buffer, as views of it."""
    boxes_at, images_at, _ = staging_layout(B, K, bucket)
    return (buf[:24 * B].view(torch.int64).view(B, 3),
            buf[boxes_at:images_at].view(torch.float32).view(B, K, 4))


def stage_requests(buf: torch.Tensor, requests: Sequence[Tuple[np.ndarray, ...]],
                   boxes: np.ndarray, bucket: Tuple[int, int]):
    """Write a call's requests into ``buf`` (a flat uint8 CPU tensor of at
    least ``staging_layout``'s bytes): each request's (byte offset, h, w)
    into the table, ``boxes`` (``request_boxes``) after it, each raw image
    after those, back to back with no padding; an image larger than the
    bucket is downscaled first (``fit_to_bucket``), counted in
    ``serve.pack_resized``. The copies are numpy's, on the calling thread:
    torch's ``copy_``, which hands a large copy to its intra-op threads,
    took ~6 ms for one image on an H100's host and raised a one-image
    call's p95 by as much. Counts the
    pixels as ``pack_requests`` does. Returns (bytes used, original (w, h)
    per request)."""
    B, K, _ = boxes.shape
    table, staged_boxes = (v.numpy() for v in staged_views(buf, B, K, bucket))
    staged_boxes[...] = boxes
    off = staging_layout(B, K, bucket)[1]
    flat = buf.numpy()
    sizes = []
    for i, (image, *_) in enumerate(requests):
        _check_image(image)
        sizes.append((image.shape[1], image.shape[0]))
        h, w = fit_to_bucket(*image.shape[:2], bucket)
        if (h, w) != image.shape[:2]:
            image = _resize_bilinear(image, h, w)
            trace.count("serve.pack_resized")
        flat[off:off + h * w * 3].reshape(h, w, 3)[...] = image
        table[i] = off, h, w
        trace.count("serve.px_real", h * w)
        off += _aligned(h * w * 3)
    trace.count("serve.px_bucket", B * bucket[0] * bucket[1])
    return off, sizes


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
    """Serves a CountingDetr of either stage under any of its priors.
    Weights come from ``state_dict`` or, without one, from ``seed``.
    ``bucket`` is one (H, W) bucket or a tuple of them (``buckets``); the
    attribute ``bucket`` is the one the call last staged went into (the
    first before any call).

    The predictor owns one staging buffer on the host (pinned on a card)
    and one on the device, each grown to the most bytes a call's B can
    take at its first call of that B in its largest bucket: the warm-up
    calls allocate them. A call waits for the previous call's copy to have
    left the host buffer before it writes there."""

    def __init__(self, cfg: ModelConfig, state_dict: Optional[dict] = None,
                 device="cuda", bucket=(592, 592), seed: int = 0):
        self.model = build_model(cfg, device=device, seed=seed, state_dict=state_dict)
        self.device = next(self.model.parameters()).device
        one = np.ndim(bucket) == 1
        self.buckets = tuple(tuple(int(n) for n in b) for b in ([bucket] if one else bucket))
        self.bucket = self.buckets[0]  # the bucket of the call last staged
        self._host = self._dev = None  # the staging buffers, flat uint8
        # on a card: recorded after each copy from _host
        self._copied = torch.cuda.Event() if self.device.type == "cuda" else None

    @torch.inference_mode()
    def forward(self, images, pad_mask, exemplar_boxes=None, points=None,
                points_valid=None) -> Dict[str, torch.Tensor]:
        """One forward of a packed batch (stage 2's exemplar boxes; the
        points for the sampled and defined priors): tensors on the
        predictor's device, or the numpy arrays of ``pack_requests`` (and
        ``pack_points``), copied here; with the mask head, its
        ``pred_masks`` (B, L, H/4, W/4) logits too. The model gets only the
        prior arguments its stage takes."""
        arrays = [images, pad_mask]
        if self.model.cfg.stage == 2:
            arrays.append(exemplar_boxes)
        if points is not None:
            arrays += [points, points_valid]
        if any(not isinstance(a, torch.Tensor) or a.device != self.device for a in arrays):
            with trace.span("serve.h2d"):
                arrays = [torch.as_tensor(a).to(self.device, non_blocking=True) for a in arrays]
        with trace.span("serve.model"):
            return self.model(*arrays, aux_outputs=False)

    def predict(self, requests: Sequence[Tuple[np.ndarray, ...]]) -> List[Dict]:
        with trace.span("serve.predict"):
            return self._predict(requests)

    def _stage(self, requests: Sequence[Tuple[np.ndarray, ...]]):
        """The requests into the host staging buffer, in the bucket
        ``pick_bucket`` gives them (kept for ``_upload``): (bytes used,
        boxes shape, original (w, h) per request)."""
        if not requests:
            raise ValueError("predict takes at least one request")
        boxes = request_boxes(requests, self.model.cfg.stage == 2)
        self.bucket = pick_bucket([r[0].shape[:2] for r in requests], self.buckets)
        need = max(staging_layout(*boxes.shape[:2], b)[2] for b in self.buckets)
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < need:
            self._host = torch.empty(need, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
            self._dev = torch.empty(need, dtype=torch.uint8, device=self.device)
        used, sizes = stage_requests(self._host, requests, boxes, self.bucket)
        return used, boxes.shape, sizes

    def _upload(self, used: int, boxes_shape: Tuple[int, ...]):
        """The staged bytes to the device in one copy, then the pack kernel
        into the staged call's bucket: (images, pad_mask, exemplar boxes)
        on the device."""
        self._dev[:used].copy_(self._host[:used], non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        table, boxes = staged_views(self._dev, *boxes_shape[:2], self.bucket)
        return (*pack_kernel.pack_images(self._dev, table, self.bucket), boxes)

    def _predict(self, requests: Sequence[Tuple[np.ndarray, ...]]) -> List[Dict]:
        points = valid = None
        prior = self.model.cfg.spatial_prior
        with trace.span("serve.pack"):
            used, boxes_shape, sizes = self._stage(requests)
            if prior in POINTS_PRIORS:
                if any(len(r) < 3 for r in requests):
                    raise ValueError(f"the {prior} prior takes (image, boxes, points) requests")
                points, valid = pack_points(requests)
        with trace.span("serve.h2d"):
            images, masks, rects = self._upload(used, boxes_shape)
            if points is not None:
                points, valid = (torch.from_numpy(a).to(self.device, non_blocking=True)
                                 for a in (points, valid))
        out = self.forward(images, masks, rects, points, valid)
        if self.model.cfg.stage == 1:
            return self._detections(out, sizes)
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

    def _detections(self, out: Dict[str, torch.Tensor], sizes) -> List[Dict]:
        """Stage 1's results: ``topk_postprocess`` of the forward on the
        device (its boxes ``pred_points`` and ``pred_wh`` as cxcywh), read
        back."""
        with trace.span("serve.topk"):
            logits = out["pred_logits"]
            boxes = torch.cat([out["pred_points"], out["pred_wh"]], dim=-1)
            hw = torch.tensor([(h, w) for w, h in sizes], dtype=torch.float32)
            top = topk_postprocess(logits, boxes, hw.to(self.device), k=TOPK)
            scores, labels, xyxy = (top[n].cpu().numpy() for n in ("scores", "labels", "boxes"))
        return [{"scores": scores[i], "labels": labels[i], "boxes_xyxy_px": xyxy[i]}
                for i in range(len(sizes))]

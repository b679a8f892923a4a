"""COCO-style AP evaluation in numpy (countdetr_tpu/eval/coco_eval.py).

The reference evaluates with detectron2's COCOeval_opt at
maxDets=[900, 1000, 1100] (reference eval_all.py:516,18). This is the
standard COCO protocol for one category: greedy score-ordered matching at
10 IoU thresholds, 101-point interpolated precision, the area ranges, the
maxDets truncation and the crowd rules of pycocotools' evaluateImg: a crowd
gt is always ignored, its IoU denominator is the det's area alone, and it
is never consumed (many dets may match it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from countdetr_tpu_torch.eval import native_match

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def box_iou_xywh(d: np.ndarray, g: np.ndarray, crowd: np.ndarray = None) -> np.ndarray:
    """IoU of (N, 4) and (M, 4) xywh boxes; for a crowd gt the denominator
    is the det's area (pycocotools maskUtils.iou's iscrowd mode)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx = np.stack([d[:, 0], d[:, 1], d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]], 1)
    gx = np.stack([g[:, 0], g[:, 1], g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]], 1)
    lt = np.maximum(dx[:, None, :2], gx[None, :, :2])
    rb = np.minimum(dx[:, None, 2:], gx[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ad = d[:, 2] * d[:, 3]
    ag = g[:, 2] * g[:, 3]
    union = ad[:, None] + ag[None, :] - inter
    if crowd is not None and np.any(crowd):
        union = np.where(np.asarray(crowd, bool)[None, :],
                         np.broadcast_to(ad[:, None], union.shape), union)
    return inter / np.maximum(union, 1e-12)


def _match_image(dets, gts, gt_ignore, iou, iou_thrs, max_det, gt_crowd=None):
    """Greedy COCO matching of one image, the dets in score order, iou
    (N, M). Returns (matched gt index or -1 (T, N), matched an ignored gt
    (T, N)). Runs in native/cocoeval.cpp (eval/native_match.py), else in
    numpy (``_match_image_py``), with the same result."""
    N = min(len(dets), max_det)
    M = iou.shape[1]
    if gt_crowd is None:
        gt_crowd = np.zeros(M, dtype=bool)
    native = native_match.match_image(
        np.asarray(iou[:N], np.float64), np.asarray(gt_ignore, bool),
        np.asarray(iou_thrs, np.float64), np.asarray(gt_crowd, bool))
    if native is not None:
        return native
    return _match_image_py(dets, gts, gt_ignore, iou, iou_thrs, max_det, gt_crowd)


def _match_image_py(dets, gts, gt_ignore, iou, iou_thrs, max_det, gt_crowd=None):
    """The numpy matcher. The gts are scanned ignored-last (pycocotools
    sorts them so before its greedy loop), which makes the early break on
    reaching an ignored gt valid."""
    N = min(len(dets), max_det)
    M = iou.shape[1]
    T = len(iou_thrs)
    if gt_crowd is None:
        gt_crowd = np.zeros(M, dtype=bool)
    g_order = np.argsort(gt_ignore, kind="mergesort")  # real gts first
    gt_ignore = np.asarray(gt_ignore)[g_order]
    gt_crowd = np.asarray(gt_crowd)[g_order]
    iou = iou[:, g_order]
    det_m = -np.ones((T, N), dtype=np.int64)
    det_ig = np.zeros((T, N), dtype=bool)
    for ti, t in enumerate(iou_thrs):
        gt_taken = np.zeros(M, dtype=bool)
        for di in range(N):
            best, best_iou = -1, min(t, 1 - 1e-10)
            for gi in range(M):
                if gt_taken[gi] and not gt_crowd[gi]:
                    continue  # a crowd gt is never consumed
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break  # matched a real gt: never switch to an ignored one
                if iou[di, gi] < best_iou:
                    continue
                best_iou = iou[di, gi]
                best = gi
            if best >= 0:
                gt_taken[best] = True
                det_m[ti, di] = g_order[best]
                det_ig[ti, di] = gt_ignore[best]
    return det_m, det_ig


class CocoEvaluator:
    """Accumulates the detections and GT of each image and computes AP and
    AR. ``add_image(dets_xywh, scores, gts_xywh, gt_iscrowd=None)`` takes
    pixel boxes."""

    def __init__(self, max_dets: Sequence[int] = (900, 1000, 1100)):
        self.max_dets = sorted(max_dets)
        self.images: List[Dict] = []

    def add_image(self, dets_xywh, scores, gts_xywh, gt_iscrowd=None):
        dets_xywh = np.asarray(dets_xywh, dtype=np.float64).reshape(-1, 4)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        gts_xywh = np.asarray(gts_xywh, dtype=np.float64).reshape(-1, 4)
        order = np.argsort(-scores, kind="mergesort")
        crowd = (np.zeros(len(gts_xywh), dtype=bool) if gt_iscrowd is None
                 else np.asarray(gt_iscrowd, dtype=bool).reshape(-1))
        dets = dets_xywh[order]
        self.images.append({
            "dets": dets, "scores": scores[order], "gts": gts_xywh, "gt_crowd": crowd,
            "gt_areas": gts_xywh[:, 2] * gts_xywh[:, 3], "det_areas": dets[:, 2] * dets[:, 3],
        })

    def _accumulate(self, area_rng, max_det):
        """(precision (T, R), recall (T,)) for one area range and maxDets;
        (None, None) when no gt is in range."""
        T = len(IOU_THRS)
        lo, hi = area_rng
        all_scores, all_tp, all_ig = [], [], []
        n_gt = 0
        for im in self.images:
            # a crowd gt is ignored whatever its area (pycocotools _prepare)
            gt_ignore = (im["gt_areas"] < lo) | (im["gt_areas"] > hi) | im["gt_crowd"]
            n_gt += int((~gt_ignore).sum())
            dets = im["dets"][:max_det]
            scores = im["scores"][:max_det]
            iou = box_iou_xywh(dets, im["gts"], im["gt_crowd"])
            det_m, det_ig = _match_image(scores, im["gts"], gt_ignore, iou, IOU_THRS, max_det,
                                         gt_crowd=im["gt_crowd"])
            # an unmatched det outside the area range is ignored too
            areas = im["det_areas"][:len(scores)]
            det_ig = det_ig | ((det_m == -1) & ((areas < lo) | (areas > hi))[None, :])
            all_scores.append(scores)
            all_tp.append(det_m >= 0)
            all_ig.append(det_ig)
        if n_gt == 0:
            return None, None
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tp = np.concatenate(all_tp, axis=1) if all_tp else np.zeros((T, 0), dtype=bool)
        ig = np.concatenate(all_ig, axis=1) if all_ig else np.zeros((T, 0), dtype=bool)
        order = np.argsort(-scores, kind="mergesort")
        tp, ig = tp[:, order], ig[:, order]
        precision = -np.ones((T, len(REC_THRS)))
        recall = -np.ones((T,))
        for ti in range(T):
            tps = tp[ti][~ig[ti]].astype(np.float64)
            ctp = np.cumsum(tps)
            cfp = np.cumsum(1.0 - tps)
            rc = ctp / n_gt
            pr = ctp / np.maximum(ctp + cfp, 1e-12)
            for i in range(len(pr) - 1, 0, -1):  # the precision envelope
                pr[i - 1] = max(pr[i - 1], pr[i])
            recall[ti] = rc[-1] if len(rc) else 0.0
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[ti] = q
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        """AP, AP50, AP75, APs/m/l at the largest maxDets and AR@each
        maxDets; -1.0 where no gt is in range."""
        md = self.max_dets[-1]

        def ap_of(precision, thr=None):
            if precision is None:
                return -1.0
            p = precision if thr is None else precision[[np.argmin(np.abs(IOU_THRS - thr))]]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        pr_all, _ = self._accumulate(AREA_RANGES["all"], md)
        out: Dict[str, float] = {"AP": ap_of(pr_all), "AP50": ap_of(pr_all, 0.5),
                                 "AP75": ap_of(pr_all, 0.75)}
        for key, name in (("small", "APs"), ("medium", "APm"), ("large", "APl")):
            out[name] = ap_of(self._accumulate(AREA_RANGES[key], md)[0])
        for m in self.max_dets:
            _, rc = self._accumulate(AREA_RANGES["all"], m)
            out[f"AR@{m}"] = (float(rc[rc > -1].mean())
                              if rc is not None and (rc > -1).any() else -1.0)
        return out

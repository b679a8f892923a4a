"""Counting metrics (countdetr_tpu/eval/counting.py; reference
eval_all.py:252-270): with err_i = |gt_i - pred_i|,
  MAE = mean(err), RMSE = sqrt(mean(err^2)), NAE = mean(err / gt),
  SRE = sqrt(mean(err^2 / gt)),
and MRE, the LVIS evaluator's name for NAE (offline_lvis_evaluator.py:241-252).
"""

from __future__ import annotations

from typing import Dict, Sequence


def counting_metrics(gt_counts: Sequence[int], pred_counts: Sequence[int]) -> Dict[str, float]:
    if len(gt_counts) != len(pred_counts) or not gt_counts:
        raise ValueError(f"need equal, non-empty count lists, got {len(gt_counts)} "
                         f"and {len(pred_counts)}")
    n = len(gt_counts)
    sae = sse = nae = sre = 0.0
    for g, p in zip(gt_counts, pred_counts):
        err = abs(g - p)
        sae += err
        sse += err ** 2
        nae += err / max(g, 1e-9)
        sre += err ** 2 / max(g, 1e-9)
    return {"MAE": sae / n, "RMSE": (sse / n) ** 0.5, "NAE": nae / n, "MRE": nae / n,
            "SRE": (sre / n) ** 0.5, "images": n}

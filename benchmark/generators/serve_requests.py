"""Serving traffic: a pool of (uint8 image, three exemplar boxes) requests
made from the seed, which a closed loop of one client sends in calls of
``requests_per_call``, cycling through the pool.

The mix's parameters (``benchmark/traffic/<name>.json``):
  heights, widths   the image sizes; the pool holds every (h, w) pair
                    ``per_size`` times, so every seed serves the same sizes,
                    in an order the seed draws
  bucket            (H, W) the serving bucket, which every size fits
  exemplar_size     [min, max] side of an exemplar box, a share of the image
  exemplar_area     [lo, hi]: each box lies in this share of the image, so
                    it is inside the content in the image's own frame and in
                    the bucket's
  requests_per_call the requests one ``predict`` call carries
The pixels come from one draw of a torch generator on the device (on the
host only for tests), copied to the host once: a request is an HWC uint8
numpy view of that buffer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def generate(mix: Dict, seed: int, device) -> Dict:
    rng = np.random.default_rng(seed)
    sizes = [(h, w) for h in mix["heights"] for w in mix["widths"]] * mix["per_size"]
    order = rng.permutation(len(sizes))
    sizes = [sizes[i] for i in order]
    total = sum(h * w * 3 for h, w in sizes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randint(0, 256, (total,), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()
    lo, hi = mix["exemplar_area"]
    smin, smax = mix["exemplar_size"]
    requests: List[tuple] = []
    at = 0
    for h, w in sizes:
        image = flat[at:at + h * w * 3].reshape(h, w, 3)
        at += h * w * 3
        side = rng.uniform(smin, smax, (3, 2))
        corner = lo + rng.uniform(0.0, 1.0, (3, 2)) * (hi - lo - side)
        boxes = np.concatenate([corner, corner + side], axis=1).astype(np.float32)
        requests.append((image, boxes))
    bucket = tuple(mix["bucket"])
    if any(h > bucket[0] or w > bucket[1] for h, w in sizes):
        raise ValueError(f"a size exceeds the bucket {bucket}")
    return {"requests": requests, "bucket": bucket,
            "requests_per_call": int(mix["requests_per_call"]),
            "largest": max(range(len(sizes)), key=lambda i: sizes[i][0] * sizes[i][1])}


def calls(traffic: Dict, start: int, n: int) -> List[List[int]]:
    """The pool indices of calls start .. start + n - 1, cycling."""
    k = traffic["requests_per_call"]
    size = len(traffic["requests"])
    return [[(c * k + j) % size for j in range(k)] for c in range(start, start + n)]

"""Pseudo-labelling traffic: images with annotated dots whose counts follow
FSC-147's published statistics (Ranjan et al., CVPR 2021, arXiv
2104.08391: 6135 images, 7 to 3731 objects an image, mean 56), as a
dataset that the program's Batcher reads.

The mix's parameters (``benchmark/traffic/<name>.json``):
  height, widths     every image is ``height`` high; a block's widths are
                     ``widths`` repeated to ``block`` slots, so every seed
                     has the same widths, in an order the seed draws
  block              images a block, the unit of a pass's length
  dataset_images     the counts of one dataset: the (i + 0.5) / n
                     quantiles of a log-normal of median
                     ``lognormal_median`` and sigma ``lognormal_sigma``,
                     rounded and clipped to [min_points, max_points], the
                     largest of them set to ``max_points`` (the source's
                     one densest image); a pass runs through the dataset
                     again and again, each time in a fresh order the seed
                     draws, so a pass of whole datasets gives every seed
                     the same counts
  warm_counts        the point counts of the set-up images, one in each
                     point tier, in each width of ``warm_widths``
The seed draws the pixels (a pool of ``block`` arrays, one per width slot,
shared by reference by every block), the dot positions (fresh in every
block, uniform in [0.01, 0.99]) and the orders. Block b depends on (seed, b)
alone, so a shorter pass is a prefix of a longer one.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch

from benchmark.generators.point_dataset import PointDataset


def dataset_counts(mix: Dict) -> List[int]:
    """One dataset's point counts, ascending."""
    n = mix["dataset_images"]
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    counts = [int(round(mix["lognormal_median"] * math.exp(mix["lognormal_sigma"] * v)))
              for v in z]
    counts = [min(max(c, mix["min_points"]), mix["max_points"]) for c in counts]
    return counts[:-1] + [mix["max_points"]]


def _pixels(sizes, seed: int, device) -> List[np.ndarray]:
    total = sum(h * w * 3 for h, w in sizes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randint(0, 256, (total,), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()
    out, at = [], 0
    for h, w in sizes:
        out.append(flat[at:at + h * w * 3].reshape(h, w, 3))
        at += h * w * 3
    return out


def generate(mix: Dict, seed: int, device) -> Dict:
    """A seeded maker of datasets, ``dataset(n, start)``: the seed's blocks
    start .. start + n - 1; the block's size; ``warm``, the set-up images."""
    rng = np.random.default_rng(seed)
    n = mix["block"]
    widths = [mix["widths"][i % len(mix["widths"])] for i in range(n)]
    widths = [widths[i] for i in rng.permutation(n)]
    h = mix["height"]
    pool = _pixels([(h, w) for w in widths], seed, device)
    counts = dataset_counts(mix)
    warm_sizes = [(h, w) for w in mix["warm_widths"] for _ in mix["warm_counts"]]
    warm_pool = _pixels(warm_sizes, seed + 1, device)
    warm_points = [rng.uniform(0.01, 0.99, (k, 2)).astype(np.float32)
                   for _ in mix["warm_widths"] for k in mix["warm_counts"]]
    orders: Dict[int, np.ndarray] = {}

    def count(p: int) -> int:  # the pass's p-th image
        rep, at = divmod(p, len(counts))
        if rep not in orders:
            orders[rep] = np.random.default_rng([seed, 1, rep]).permutation(len(counts))
        return counts[orders[rep][at]]

    def dataset(blocks: int, start: int = 0) -> PointDataset:
        which, points = [], []
        for b in range(start, start + blocks):  # block b's dots come from (seed, b) alone
            r = np.random.default_rng([seed, b])
            for j in range(n):
                which.append(j)
                points.append(r.uniform(0.01, 0.99, (count(b * n + j), 2)).astype(np.float32))
        return PointDataset(pool, which, points)

    return {"dataset": dataset, "block": n,
            "warm": PointDataset(warm_pool, list(range(len(warm_pool))), warm_points,
                                 first_id=10**9)}

"""Detection traffic at COCO's evaluation sizes: a pool of (uint8 image,)
requests made from the seed, which a closed loop of one client sends in
calls of ``requests_per_call`` images of one orientation (landscape and
square, or portrait), as an aspect-ratio-grouping evaluator batches them.

The mix's parameters (``benchmark/traffic/<name>.json``):
  sizes             the pool: each entry's ``requests`` images of ``h`` x
                    ``w`` (its ``shape`` names it); every seed holds the same
                    sizes, in an order the seed draws
  buckets           [landscape (H, W), portrait (H, W)]: the predictor's
                    buckets; every landscape or square size fits the first,
                    every portrait size the second
  requests_per_call the requests one ``predict`` call carries
  cycle_calls       the calls of one cycle of the schedule: of them, the
                    portrait pool's share (rounded) are portrait calls, in an
                    order the seed draws; each orientation's calls take its
                    pool's requests in turn, cycling
The pixels come from one draw of a torch generator on the device (on the
host only for tests), copied to the host once: a request is an HWC uint8
numpy view of that buffer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LANDSCAPE, PORTRAIT = 0, 1


def generate(mix: Dict, seed: int, device) -> Dict:
    rng = np.random.default_rng(seed)
    pool = [(s["h"], s["w"], s["shape"]) for s in mix["sizes"] for _ in range(s["requests"])]
    pool = [pool[i] for i in rng.permutation(len(pool))]
    buckets = [tuple(b) for b in mix["buckets"]]
    groups: List[List[int]] = [[], []]
    for i, (h, w, _) in enumerate(pool):
        side = PORTRAIT if h > w else LANDSCAPE
        if h > buckets[side][0] or w > buckets[side][1]:
            raise ValueError(f"{h}x{w} exceeds its bucket {buckets[side]}")
        groups[side].append(i)
    cycle = int(mix["cycle_calls"])
    portrait = round(cycle * len(groups[PORTRAIT]) / len(pool))
    if not 0 < portrait < cycle:
        raise ValueError("the schedule needs calls of both orientations")
    schedule = rng.permutation([LANDSCAPE] * (cycle - portrait) + [PORTRAIT] * portrait).tolist()
    total = sum(h * w * 3 for h, w, _ in pool)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randint(0, 256, (total,), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()
    requests: List[tuple] = []
    at = 0
    for h, w, _ in pool:
        requests.append((flat[at:at + h * w * 3].reshape(h, w, 3),))
        at += h * w * 3
    return {"requests": requests, "shapes": [s for _, _, s in pool], "buckets": buckets,
            "groups": groups, "schedule": schedule,
            "requests_per_call": int(mix["requests_per_call"])}


def orientation(traffic: Dict, c: int) -> int:
    """LANDSCAPE or PORTRAIT: the orientation of call ``c``."""
    sched = traffic["schedule"]
    return sched[c % len(sched)]


def calls(traffic: Dict, start: int, n: int) -> List[List[int]]:
    """The pool indices of calls start .. start + n - 1: call c takes the
    next ``requests_per_call`` requests of its orientation's pool, after
    those that the calls of that orientation before it took, cycling."""
    sched, k = traffic["schedule"], traffic["requests_per_call"]
    out = []
    for c in range(start, start + n):
        side = orientation(traffic, c)
        cycles, at = divmod(c, len(sched))
        before = cycles * sched.count(side) + sched[:at].count(side)
        members = traffic["groups"][side]
        out.append([members[(before * k + j) % len(members)] for j in range(k)])
    return out

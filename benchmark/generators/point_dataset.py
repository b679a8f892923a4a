"""The pseudo-labelling traffic's dataset, in a module of its own that
imports numpy only: the Batcher's spawned workers import it to unpickle the
dataset, and an import of torch there would cost each new pool seconds
before its first batch."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class PointDataset:
    """Indexable of the Batcher's sample dicts: ``image`` (h, w, 3) uint8,
    ``points`` (k, 2) normalised (x, y), ``orig_size`` (w, h), ``image_id``,
    ``image_name``; ``image_size`` and ``num_points`` let the Batcher plan
    without loading pixels. Picklable, for the Batcher's spawned workers."""

    def __init__(self, pool: Sequence[np.ndarray], which: Sequence[int],
                 points: Sequence[np.ndarray], first_id: int = 1):
        self.pool = list(pool)
        self.which = list(which)
        self.points = list(points)
        self.first_id = first_id

    def __len__(self) -> int:
        return len(self.which)

    def image_size(self, i: int):
        return self.pool[self.which[i]].shape[:2]

    def num_points(self, i: int) -> int:
        return len(self.points[i])

    def __getitem__(self, i: int) -> Dict:
        image = self.pool[self.which[i]]
        h, w = image.shape[:2]
        image_id = self.first_id + i
        return {"image": image, "points": self.points[i], "orig_size": (w, h),
                "image_id": image_id, "image_name": f"{image_id}.jpg"}

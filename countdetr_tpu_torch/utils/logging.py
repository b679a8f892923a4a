"""Windowed metric logging (countdetr_tpu/utils/logging.py; the reference's
MetricLogger and SmoothedValue, util/misc.py:31-87,160-252, without the
distributed reduction).

``MetricLogger.step`` takes the step's metrics as 0-d tensors on the card
and reads them (a host sync) only on the steps it prints. Its summary is
the mean over the printed steps, as in the JAX package. Under data
parallelism every rank reads the same global metrics; rank 0 prints.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from typing import Dict

from countdetr_tpu_torch.core.mesh import is_main_process


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.d = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.d.append(v)
        self.total += v
        self.count += 1

    @property
    def avg(self):
        return sum(self.d) / max(len(self.d), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, print_every: int = 100, prefix: str = ""):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.print_every = print_every
        self.prefix = prefix
        self._t0 = time.time()
        self._step = 0

    def update(self, **kw):
        for k, v in kw.items():
            self.meters[k].update(float(v))

    def step(self, metrics: Dict, force: bool = False):
        """Once per step; the metrics are read and printed every
        ``print_every`` steps, or on this one with ``force``."""
        self._step += 1
        if force or self._step % self.print_every == 0:
            self.update(**{k: float(v) for k, v in metrics.items()})
            rate = self._step / max(time.time() - self._t0, 1e-9)
            parts = "  ".join(f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items()))
            if is_main_process():
                print(f"{self.prefix}[{self._step}] {parts}  ({rate:.2f} it/s)", flush=True)

    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


def append_log(path: str, record: Dict):
    """Append one JSON line (reference main.py:324-326 log.txt)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")

"""Serving driver: ``countdetr_tpu_torch.serve.Predictor.predict`` called
back to back by one client (a closed loop), each call carrying the mix's
``requests_per_call`` requests from the generator's pool.

The cell's parameters (``benchmark/workloads/<name>.json``):
  warmup_calls     calls made in set-up, at the window's one shape
  profiled_calls   calls in the profiled sub-window of a traced run
  check            the output check: ``sample_calls`` calls drawn from the
                   seed among those the window finished (one holding the
                   pool's largest image among them), and the ``limits``

The window keeps a reference to each call's forward outputs (the
predictor's ``forward``, wrapped here, returns them to ``predict``), so
that the check judges what the timed calls computed:
  logit_gap, box_gap, var_gap  the largest |program - reference| of the
      class logits, the boxes (normalised cxcywh) and the variance head
      over the sampled requests' queries, the reference recomputing each
      request from its image and boxes (``benchmark/reference``);
  served_mismatch  requests whose served count, threshold, boxes and
      scores differ from what the counting rule (``reference/counting.py``)
      gives on those same forward outputs: exact, limit 0.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
from torch.profiler import record_function

from benchmark.generators.serve_requests import calls
from benchmark.harness import Check, Window
from benchmark.reference import counting, model as reference, weights

OUTPUTS = ("pred_logits", "pred_boxes", "pred_vars")


class Driver:
    def __init__(self, cfg: Dict, mix: Dict, cell: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.cell, self.traffic = cfg, cell, traffic
        self.seed, self.device = seed, device
        self.done: List[tuple] = []  # (pool indices, served results, forward outputs)
        self.calls = 0

    def setup(self):
        from countdetr_tpu_torch.config import ModelConfig
        from countdetr_tpu_torch.serve import Predictor

        m = self.cfg["model"]
        self.state = weights.draw_to_host(m, self.cfg["weights"], self.seed, self.device)
        self.predictor = Predictor(ModelConfig(**m), state_dict=self.state, device=self.device,
                                   bucket=self.traffic["bucket"], seed=0)
        forward = self.predictor.forward
        self.last = None

        def captured(*args, **kw):
            with record_function("model_forward"):
                out = forward(*args, **kw)
            self.last = {k: out[k] for k in OUTPUTS}
            return out

        self.predictor.forward = captured
        for idx in calls(self.traffic, 0, self.cell["warmup_calls"]):
            self._call(idx)
        self.calls = self.cell["warmup_calls"]

    def _call(self, idx: List[int]):
        with record_function("predict"):
            return self.predictor.predict([self.traffic["requests"][i] for i in idx])

    def window(self, seconds: float) -> Window:
        win = Window()
        reqs = self.traffic["requests"]
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            idx = calls(self.traffic, self.calls, 1)[0]
            self.calls += 1
            win.attempted += len(idx)
            t0 = time.perf_counter()
            try:
                results = self._call(idx)
            except Exception as e:  # a failed call counts against every request in it
                print(f"predict raised {type(e).__name__}: {e}", file=sys.stderr, flush=True)
                win.failed += len(idx)
                win.latencies_s += [float("inf")] * len(idx)
                continue
            dt = time.perf_counter() - t0
            win.latencies_s += [dt] * len(idx)
            win.images += [(*reqs[i][0].shape[:2], 0) for i in idx]
            self.done.append((idx, results, self.last))
        win.seconds = time.perf_counter() - t_start
        return win

    def profiled(self):
        reqs = self.traffic["requests"]
        images = []
        batches = calls(self.traffic, self.calls, self.cell["profiled_calls"])
        self.calls += len(batches)
        for idx in batches:
            self._call(idx)
            images += [(*reqs[i][0].shape[:2], 0) for i in idx]
        return images, sum(len(b) for b in batches)

    def release(self):
        self.predictor = None
        self.last = None

    def sample(self) -> List[int]:
        """Indices into ``done`` of the calls the check compares."""
        n = min(self.cell["check"]["sample_calls"], len(self.done))
        rng = np.random.default_rng([self.seed, 1])
        picked = rng.choice(len(self.done), size=n, replace=False).tolist()
        largest = [c for c, (idx, _, _) in enumerate(self.done)
                   if self.traffic["largest"] in idx]
        if picked and largest and not set(picked) & set(largest):
            picked[0] = largest[0]
        return sorted(picked)

    def compare(self) -> List[Check]:
        limits = self.cell["check"]["limits"]
        picked = self.sample()
        reqs = self.traffic["requests"]
        items, program = [], {k: [] for k in OUTPUTS}
        mismatch = 0
        for c in picked:
            idx, results, out = self.done[c]
            host = {k: out[k].float().cpu().numpy() for k in OUTPUTS}
            sizes = [(reqs[i][0].shape[1], reqs[i][0].shape[0]) for i in idx]
            want = counting.served(host["pred_logits"], host["pred_boxes"], sizes)
            mismatch += sum(not counting.same(g, w) for g, w in zip(results, want))
            for j, i in enumerate(idx):
                image, boxes = reqs[i]
                items.append({"image": image, "exemplars": boxes, "bucket": self.traffic["bucket"]})
                for k in OUTPUTS:
                    program[k].append(host[k][j])
        self.done = []
        state = {k: v.to(self.device) for k, v in self.state.items()}
        ref = reference.run(state, self.cfg["model"], items, self.device)
        del state
        gaps = {}
        for key, name in (("pred_logits", "logit_gap"), ("pred_boxes", "box_gap"),
                          ("pred_vars", "var_gap")):
            gaps[name] = max((float(np.abs(p - r[key]).max())
                              for p, r in zip(program[key], ref)), default=float("inf"))
        checks = [Check(name, value, limits[name]) for name, value in gaps.items()]
        checks.append(Check("served_mismatch", float(mismatch) if items else float("inf"),
                            limits["served_mismatch"]))
        return checks

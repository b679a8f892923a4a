"""Detection driver: ``countdetr_tpu_torch.serve.Predictor.predict`` of a
stage-1 model (Anchor DETR) in two orientation buckets, called back to back
by one client (a closed loop), each call carrying ``requests_per_call``
images of one orientation (``benchmark/generators/coco_requests.py``).

The cell's parameters (``benchmark/workloads/<name>.json``):
  warmup_calls     calls of each orientation made in set-up, so that both
                   buckets are warm at the window's batch size
  profiled_calls   consecutive calls in the profiled sub-window of a traced
                   run, the first such run from the window's next call on
                   that holds a portrait call
  check            the output check: ``sample_calls`` calls among those the
                   window finished, for each of ``sample_shapes`` one
                   holding an image of that shape (a portrait shape gives
                   a portrait call), the rest drawn from the seed; and the
                   ``limits``

Each completed image counts as (h, w, num_query_position): the work
counters (``benchmark/yardstick/work.py``) multiply the learned prior's
positions by its patterns. The window keeps a reference to each call's
forward outputs (the predictor's ``forward``, wrapped here, returns them to
``predict``), so that the check judges what the timed calls computed:
  logit_gap, box_gap  the largest |program - reference| of the class
      logits and of the boxes (normalised cxcywh: ``pred_points`` and
      ``pred_wh``) over the sampled requests' queries, the reference
      recomputing each request from its image, padded into the bucket the
      program chose (``benchmark/reference/anchor_detr.py``);
  served_mismatch  requests whose served top-100 scores, labels and boxes
      differ from what ``benchmark/reference/topk.py`` gives on those same
      forward outputs, on their device: exact, limit 0.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import predict_loop
from benchmark.generators.coco_requests import PORTRAIT, calls, orientation
from benchmark.harness import Check, Window
from benchmark.reference import anchor_detr, topk
from benchmark.reference.model import smallest_bucket

OUTPUTS = ("pred_logits", "pred_points", "pred_wh")


class Driver(predict_loop.Driver):
    def setup(self):
        from countdetr_tpu_torch.config import ModelConfig
        from countdetr_tpu_torch.serve import Predictor

        m = self.cfg["model"]
        self.positions = int(m["num_query_position"])
        self.state = anchor_detr.draw_to_host(m, self.cfg["weights"], self.seed, self.device)
        self.predictor = Predictor(ModelConfig(**m), state_dict=self.state, device=self.device,
                                   bucket=self.traffic["buckets"], seed=0)
        forward = self.predictor.forward
        self.last = None

        def captured(*args, **kw):
            with record_function("model_forward"):
                out = forward(*args, **kw)
            self.last = {k: out[k] for k in OUTPUTS}
            return out

        self.predictor.forward = captured
        sched = self.traffic["schedule"]
        for side in sorted(set(sched)):
            first = sched.index(side)
            for n in range(self.cell["warmup_calls"]):
                self._call(calls(self.traffic, first + n * len(sched), 1)[0])

    def _images(self, idx: List[int]):
        reqs = self.traffic["requests"]
        return [(*reqs[i][0].shape[:2], self.positions) for i in idx]

    def window(self, seconds: float) -> Window:
        win = Window()
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
            win.latencies_s += [time.perf_counter() - t0] * len(idx)
            win.images += self._images(idx)
            self.done.append((idx, results, self.last))
        win.seconds = time.perf_counter() - t_start
        return win

    def profiled(self):
        n = self.cell["profiled_calls"]
        start = self.calls
        while PORTRAIT not in [orientation(self.traffic, c) for c in range(start, start + n)]:
            start += 1
        batches = calls(self.traffic, start, n)
        self.calls = start + n
        images = []
        for idx in batches:
            self._call(idx)
            images += self._images(idx)
        return images, sum(len(b) for b in batches)

    def sample(self) -> List[int]:
        """Indices into ``done`` of the calls the check compares: for each
        of ``sample_shapes`` a call holding such an image, then calls drawn
        from the seed."""
        check = self.cell["check"]
        n = min(check["sample_calls"], len(self.done))
        rng = np.random.default_rng([self.seed, 1])
        shapes = self.traffic["shapes"]
        picked: List[int] = []
        for shape in check["sample_shapes"][:n]:
            holding = [c for c, (idx, _, _) in enumerate(self.done)
                       if c not in picked and any(shapes[i] == shape for i in idx)]
            if holding:
                picked.append(holding[int(rng.integers(len(holding)))])
        rest = [c for c in range(len(self.done)) if c not in picked]
        picked += rng.choice(rest, size=n - len(picked), replace=False).tolist()
        return sorted(picked)

    def compare(self) -> List[Check]:
        limits = self.cell["check"]["limits"]
        picked = self.sample()
        reqs = self.traffic["requests"]
        buckets = self.traffic["buckets"]
        items: List[Dict] = []
        program: Dict[str, List[np.ndarray]] = {"pred_logits": [], "pred_boxes": []}
        mismatch = 0
        for c in picked:
            idx, results, out = self.done[c]
            boxes = torch.cat([out["pred_points"], out["pred_wh"]], dim=-1)
            sizes = [(reqs[i][0].shape[1], reqs[i][0].shape[0]) for i in idx]
            want = topk.served(out["pred_logits"], boxes, sizes)
            mismatch += sum(not topk.same(g, w) for g, w in zip(results, want))
            bucket = smallest_bucket(max(h for _, h in sizes), max(w for w, _ in sizes), buckets)
            logits = out["pred_logits"].float().cpu().numpy()
            boxes = boxes.float().cpu().numpy()
            for j, i in enumerate(idx):
                items.append({"image": reqs[i][0], "bucket": bucket})
                program["pred_logits"].append(logits[j])
                program["pred_boxes"].append(boxes[j])
        self.done = []
        state = {k: v.to(self.device) for k, v in self.state.items()}
        ref = anchor_detr.run(state, self.cfg["model"], items, self.device)
        del state
        checks = [Check(name, max((float(np.abs(p - r[key]).max())
                                   for p, r in zip(program[key], ref)), default=float("inf")),
                        limits[name])
                  for key, name in (("pred_logits", "logit_gap"), ("pred_boxes", "box_gap"))]
        checks.append(Check("served_mismatch", float(mismatch) if items else float("inf"),
                            limits["served_mismatch"]))
        return checks

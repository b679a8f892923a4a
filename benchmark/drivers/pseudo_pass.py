"""Pseudo-labelling driver: one call of
``countdetr_tpu_torch.train.engine.generate_pseudo_labels`` over the
generator's dataset, the CLI pseudo-label mode's settings from the cell
file, its COCO JSON written under TMPDIR.

The cell's parameters (``benchmark/workloads/<name>.json``):
  batch_size, buckets, max_points, num_workers, pack_s2d
                   the engine's arguments (the CLI's defaults)
  blocks_per_second  the window's work: round(--seconds x this) blocks of
                   the mix, a fixed amount for a given --seconds (a count
                   taken from a timed pass in set-up moved by 18-30 blocks
                   from run to run, and the rate with it)
  check            ``sample_images`` images drawn from the seed, among them
                   the pass's densest and one of each point tier that
                   ``tiers`` bounds (counts up to 128, up to 700, ...), and
                   the ``limits``

Set-up builds the model and runs one pass over the mix's warm-up images,
every (bucket, point tier) shape of the traffic; the window is one pass
over the blocks; the traced run profiles the window's block that holds its
densest image once more. The check reads the pass's JSON:
  layout_mismatch  annotations out of place: an image missing or twice, a
      count of boxes other than its dots, ids out of order, a centre other
      than int() of its dot in pixels, an area outside what int() of the
      width and height allows; exact, limit 0;
  wh_gap_px   over the sampled images' boxes, the largest distance in
      pixels from the written (truncated) width or height to the
      reference's untruncated one: 0 where the written value is int() of
      the reference's, else how far int() would have to be off.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
from torch.profiler import record_function

from benchmark.harness import Check, Window
from benchmark.reference import model as reference, weights


class Driver:
    def __init__(self, cfg: Dict, mix: Dict, cell: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.cell, self.traffic = cfg, cell, traffic
        self.seed, self.device = seed, device
        self.kw = {k: cell[k] for k in ("batch_size", "max_points", "num_workers", "pack_s2d")}
        self.kw["buckets"] = [tuple(b) for b in cell["buckets"]]
        self.tmp = tempfile.mkdtemp(prefix="countdetr_pseudo_")

    def setup(self):
        from countdetr_tpu_torch.config import ModelConfig
        from countdetr_tpu_torch.models.anchor_detr import build_model

        m = self.cfg["model"]
        self.state = weights.draw_to_host(m, self.cfg["weights"], self.seed, self.device)
        self.model = build_model(ModelConfig(**m), device=self.device, state_dict=self.state)
        forward = self.model.forward

        def spanned(*args, **kw):
            with record_function("model_forward"):
                return forward(*args, **kw)

        self.model.forward = spanned
        self._pass(self.traffic["warm"], "warm.json")

    def _pass(self, dataset, name: str) -> str:
        from countdetr_tpu_torch.train.engine import generate_pseudo_labels

        path = os.path.join(self.tmp, name)
        generate_pseudo_labels(self.model, dataset, path, **self.kw)
        return path

    def window(self, seconds: float) -> Window:
        blocks = max(1, int(round(seconds * self.cell["blocks_per_second"])))
        self.dataset = self.traffic["dataset"](blocks)
        ds = self.dataset
        win = Window(attempted=len(ds))
        t0 = time.perf_counter()
        try:
            self.path = self._pass(ds, "pseudo.json")
        except Exception as e:  # the pass labels nothing
            print(f"generate_pseudo_labels raised {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
            self.path = None
            win.failed = len(ds)
        win.seconds = time.perf_counter() - t0
        if self.path is not None:
            win.images = [(*ds.image_size(i), ds.num_points(i)) for i in range(len(ds))]
            win.points = sum(n for _, _, n in win.images)
        return win

    def profiled(self):
        ds, block = self.dataset, self.traffic["block"]
        one = self.traffic["dataset"](1, max(range(len(ds)), key=ds.num_points) // block)
        self._pass(one, "profiled.json")
        images = [(*one.image_size(i), one.num_points(i)) for i in range(len(one))]
        return images, len(one)

    def release(self):
        self.model = None

    def compare(self) -> List[Check]:
        limits = self.cell["check"]["limits"]
        try:
            if self.path is None:
                return [Check(k, float("inf"), v) for k, v in limits.items()]
            with open(self.path) as f:
                written = json.load(f)
            ds = self.dataset
            layout, by_image = self._layout(written, ds)
            sample = self._sample(ds)
            items = []
            for i in sample:
                h, w = ds.image_size(i)
                items.append({"image": ds[i]["image"], "points": ds[i]["points"],
                              "bucket": reference.smallest_bucket(h, w, self.kw["buckets"])})
            state = {k: v.to(self.device) for k, v in self.state.items()}
            ref = reference.run(state, self.cfg["model"], items, self.device)
            del state
            gap = 0.0
            for i, r in zip(sample, ref):
                h, w = ds.image_size(i)
                anns = by_image.get(ds.first_id + i)
                if anns is None or len(anns) != ds.num_points(i):
                    gap = float("inf")
                    continue
                got = np.asarray([a["bbox"][2:] for a in anns], np.float64)
                want = r["pred_wh"] * (w, h)
                gap = max(gap, float(np.maximum(0.0, np.maximum(got - want,
                                                                want - got - 1.0)).max()))
            return [Check("layout_mismatch", float(layout), limits["layout_mismatch"]),
                    Check("wh_gap_px", gap, limits["wh_gap_px"])]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def _sample(self, ds) -> List[int]:
        rng = np.random.default_rng([self.seed, 2])
        check = self.cell["check"]
        counts = np.asarray([ds.num_points(i) for i in range(len(ds))])
        tier = np.searchsorted(check["tiers"], counts)  # 0: up to tiers[0] points, ...
        picked = [int(np.argmax(counts))]
        for t in range(len(check["tiers"])):
            members = np.flatnonzero(tier == t)
            if len(members) and t not in tier[picked]:
                picked.append(int(rng.choice(members)))
        n = min(check["sample_images"], len(ds))
        rest = [int(i) for i in rng.permutation(len(ds)) if i not in picked]
        return sorted(picked + rest[:max(0, n - len(picked))])

    @staticmethod
    def _layout(written: Dict, ds) -> tuple:
        """(annotations out of place, {image id: its annotations})."""
        bad = 0
        ids = [im["id"] for im in written["images"]]
        want_ids = [ds.first_id + i for i in range(len(ds))]
        bad += len(set(want_ids) ^ set(ids)) + (len(ids) - len(set(ids)))
        by_image: Dict[int, list] = {}
        for a in written["annotations"]:
            by_image.setdefault(a["image_id"], []).append(a)
        expect = 1
        for a in written["annotations"]:
            bad += a["id"] != expect or a["category_id"] != 1 or a["iscrowd"] != 0
            expect += 1
        for i in range(len(ds)):
            anns = by_image.get(ds.first_id + i, [])
            pts = ds[i]["points"]
            h, w = ds.image_size(i)
            if len(anns) != len(pts):
                bad += abs(len(anns) - len(pts)) + 1
                continue
            if not anns:
                continue
            box = np.asarray([a["bbox"] for a in anns], np.int64)
            area = np.asarray([a["area"] for a in anns], np.int64)
            centre = (pts * (w, h)).astype(np.int64)  # int() of positive values
            bad += int((box[:, :2] != centre).any(axis=1).sum())
            lo = box[:, 2] * box[:, 3]
            hi = (box[:, 2] + 1) * (box[:, 3] + 1)
            bad += int(((area < lo) | (area >= hi)).sum())
        return bad, by_image

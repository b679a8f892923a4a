"""A whole run of each cell on the CPU at a tiny width (the harness's look
for a card skipped), sound and with the timed path broken underneath:
``correct`` comes out true for the sound program and false for each fault
the cell can have (a serving cell has no state or step to leave unchanged,
and no exchange between chips): an answer altered where it is produced,
half of a batch left out, a served count altered, a pseudo box dropped."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import CELLS

CELLS_PSEUDO_ALL = {**CELLS["s1_pseudo_fsc147"],
                    "cell": {**CELLS["s1_pseudo_fsc147"]["cell"],
                             "check": {"sample_images": 100, "tiers": [8, 40],
                                       "limits": {"layout_mismatch": 0, "wh_gap_px": 1e-3}}}}


def run(cell, overrides=None):
    return harness.run_cell(cell, 2**31 + 99, 0.3, False, time.perf_counter(), device="cpu",
                            overrides=overrides or CELLS[cell])


def break_forward(monkeypatch, fault):
    from countdetr_tpu_torch.models.anchor_detr import CountingDetr

    forward = CountingDetr.forward

    def broken(self, *args, **kw):
        out = dict(forward(self, *args, **kw))
        key = "pred_logits" if "pred_logits" in out and self.cfg.stage == 2 else "pred_wh"
        if fault == "altered":  # one image's answer moved where it is made
            out[key] = out[key].clone()
            out[key][0] = out[key][0] * 1.1 + 0.05
        elif fault == "half_batch":  # the second half of the batch never computed
            half = out[key].shape[0] // 2
            for k, v in list(out.items()):
                if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * half and half:
                    v = v.clone()
                    v[half:] = v[:half]
                    out[k] = v
        return out

    monkeypatch.setattr(CountingDetr, "forward", broken)


@pytest.mark.parametrize("cell", ["s2_serve_b32", "s2_serve_b1", "s1_pseudo_fsc147"])
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check" and all(
        v["value"] <= v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("cell,fault", [
    ("s2_serve_b32", "altered"), ("s2_serve_b32", "half_batch"), ("s2_serve_b1", "altered"),
    ("s1_pseudo_fsc147", "altered"), ("s1_pseudo_fsc147", "half_batch")])
def test_broken_forward_is_not_correct(cell, fault, monkeypatch):
    break_forward(monkeypatch, fault)
    over = CELLS_PSEUDO_ALL if cell == "s1_pseudo_fsc147" else None
    assert run(cell, over)["correct"] is False


@pytest.mark.parametrize("cell", ["s2_serve_b32", "s2_serve_b1"])
def test_altered_count_is_not_correct(cell, monkeypatch):
    import countdetr_tpu_torch.serve as serve

    counting = serve.adaptive_threshold_counting

    def off_by_one(prob, *a, **k):
        keep, thr = counting(prob, *a, **k)
        keep = keep.copy()
        keep[np.argmin(prob)] = not keep[np.argmin(prob)]
        return keep, thr

    monkeypatch.setattr(serve, "adaptive_threshold_counting", off_by_one)
    res = run(cell)
    assert res["correct"] is False and res["check"]["served_mismatch"]["value"] > 0


def test_dropped_annotation_is_not_correct(monkeypatch):
    import countdetr_tpu_torch.train.engine as engine

    write = engine.write_coco

    def drop_last(path, images, annotations, **kw):
        return write(path, images, annotations[:-1], **kw)

    monkeypatch.setattr(engine, "write_coco", drop_last)
    res = run("s1_pseudo_fsc147")
    assert res["correct"] is False and res["check"]["layout_mismatch"]["value"] > 0


def test_pseudo_sample_holds_the_densest_and_every_tier():
    from benchmark.drivers.pseudo_pass import Driver

    class Counts:
        def __init__(self, counts):
            self.counts = counts

        def __len__(self):
            return len(self.counts)

        def num_points(self, i):
            return self.counts[i]

    counts = [30] * 60 + [500, 3000, 3731, 200]
    for seed in range(40):
        d = Driver.__new__(Driver)
        d.seed, d.cell = seed, {"check": {"sample_images": 5, "tiers": [128, 700, 5600]}}
        picked = d._sample(Counts(counts))
        assert len(picked) == len(set(picked)) == 5 and 62 in picked  # the densest
        assert {np.searchsorted([128, 700, 5600], counts[i]) for i in picked} == {0, 1, 2}

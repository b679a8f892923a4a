"""The port's evaluation and host utilities against the JAX package, on the
CPU: the COCO evaluator (random detections over all area ranges, with
crowd GTs, maxDets 900/1000/1100 and a small maxDets that truncates), its
matchers (the native shim over native/cocoeval.cpp and the numpy one), the
counting metrics, the metric logger and the drawing helpers.

Tolerance 1e-12 on AP/AR (the same float64 numpy arithmetic on both sides;
the margin is for summation order only), 0 on matches, counts and pixels.
"""

import json

import numpy as np
import pytest

from countdetr_tpu.eval import coco_eval as jcoco
from countdetr_tpu.eval.counting import counting_metrics as jcounting
from countdetr_tpu.utils import logging as jlogging
from countdetr_tpu.utils import visualize as jvis

from countdetr_tpu_torch.eval import coco_eval, native_match
from countdetr_tpu_torch.eval.counting import counting_metrics
from countdetr_tpu_torch.utils import logging as tlogging
from countdetr_tpu_torch.utils import visualize as tvis


def random_image(rng, n_gt, n_det, size=640.0):
    """GTs in all three area ranges, a fifth of them crowds; dets are
    jittered GTs and noise."""
    s = rng.choice([8.0, 24.0, 48.0, 80.0, 120.0, 200.0], n_gt)[:, None]
    wh = s * rng.uniform(0.5, 1.5, (n_gt, 2))
    gts = np.concatenate([rng.uniform(0, 1, (n_gt, 2)) * (size - wh), wh], 1)
    crowd = rng.uniform(0, 1, n_gt) < 0.2
    jit = gts[: int(n_gt * 0.8)] * (1.0 + rng.uniform(-0.3, 0.3, (int(n_gt * 0.8), 4)))
    wh = rng.uniform(5, 150, (n_det, 2))
    noise = np.concatenate([rng.uniform(0, 1, (n_det, 2)) * (size - wh), wh], 1)
    dets = np.concatenate([jit, noise]).reshape(-1, 4)
    scores = np.concatenate([rng.uniform(0.3, 1.0, len(jit)), rng.uniform(0.0, 0.9, n_det)])
    scores[1::7] = 0.5  # ties keep their order (a stable sort on both sides)
    return dets, scores, gts, crowd


@pytest.mark.parametrize("max_dets", [(900, 1000, 1100), (3, 10, 30)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_matches_jax(seed, max_dets):
    rng = np.random.default_rng(seed)
    got_ev, want_ev = coco_eval.CocoEvaluator(max_dets), jcoco.CocoEvaluator(max_dets)
    for _ in range(6):
        d, s, g, c = random_image(rng, int(rng.integers(0, 30)), int(rng.integers(0, 40)))
        got_ev.add_image(d, s, g, gt_iscrowd=c)
        want_ev.add_image(d, s, g, gt_iscrowd=c)
    got, want = got_ev.summarize(), want_ev.summarize()
    assert set(got) == set(want) and len(got) == 9
    assert any(v > 0 for v in want.values())
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-12, rel=0), k


def test_iou_matches_jax():
    rng = np.random.default_rng(3)
    d, _, g, c = random_image(rng, 12, 10)
    for crowd in (None, c):
        np.testing.assert_array_equal(coco_eval.box_iou_xywh(d, g, crowd),
                                      jcoco.box_iou_xywh(d, g, crowd))
    assert coco_eval.box_iou_xywh(d[:0], g).shape == (0, 12)


@pytest.mark.parametrize("seed", range(4))
def test_native_shim_matches_the_numpy_matchers(seed):
    """The shim builds native/cocoeval.cpp into the port's _build/ and gives
    the numpy matcher's matches, which are JAX's."""
    assert native_match.available()
    assert native_match.library_path().parent.name == "_build"
    rng = np.random.default_rng(seed)
    d, s, g, c = random_image(rng, 25, 30)
    order = np.argsort(-s, kind="mergesort")
    d, s = d[order], s[order]
    area = g[:, 2] * g[:, 3]
    ignore = (area < 32.0 ** 2) | c
    iou = coco_eval.box_iou_xywh(d, g, c)
    for max_det in (len(s), 7):
        native = native_match.match_image(iou[:max_det], ignore, coco_eval.IOU_THRS, c)
        py = coco_eval._match_image_py(s, g, ignore, iou, coco_eval.IOU_THRS, max_det, c)
        jpy = jcoco._match_image_py(s, g, ignore, iou, jcoco.IOU_THRS, max_det, c)
        for a, b, w in zip(native, py, jpy):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
        assert (native[0] >= 0).any() or max_det < len(s)


@pytest.mark.parametrize("gt,pred", [([3, 10, 1], [4, 7, 1]), ([5], [0]), ([0, 2], [1, 2])])
def test_counting_metrics_match_jax(gt, pred):
    assert counting_metrics(gt, pred) == jcounting(gt, pred)
    with pytest.raises(ValueError):
        counting_metrics([], [])


def test_metric_logger_matches_jax(capsys, tmp_path):
    """The summary is the mean over the printed steps only, as in JAX."""
    got, want = tlogging.MetricLogger(print_every=3), jlogging.MetricLogger(print_every=3)
    for i in range(10):
        m = {"loss": 1.0 / (i + 1), "grad_norm": float(i)}
        got.step(m, force=(i == 4))
        want.step(m, force=(i == 4))
    assert got.summary() == want.summary()
    assert got.summary()["grad_norm"] == pytest.approx((2 + 4 + 5 + 8) / 4)
    sv, jsv = tlogging.SmoothedValue(window=3), jlogging.SmoothedValue(window=3)
    for v in (1.0, 5.0, 2.0, 9.0):
        sv.update(v)
        jsv.update(v)
    assert (sv.avg, sv.global_avg) == (jsv.avg, jsv.global_avg)
    tlogging.append_log(str(tmp_path / "p.txt"), {"a": 1, "epoch": 0})
    jlogging.append_log(str(tmp_path / "j.txt"), {"a": 1, "epoch": 0})
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert capsys.readouterr().out.count("[") == 2 * 4


def test_visualize_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    boxes = np.array([[20, 20, 10, 8], [50, 30, 20, 12]], np.float32)
    pts = np.array([[20, 20], [50, 30]], np.float32)
    got = tvis.draw_detections(img, boxes, pts, scores=np.array([0.9, 0.6]))
    want = jvis.draw_detections(img, boxes, pts, scores=np.array([0.9, 0.6]))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), img)
    log = tmp_path / "run" / "log.txt"
    log.parent.mkdir()
    log.write_text("\n".join(json.dumps({"loss": v, "lr": 1e-4}) for v in (3.0, 2.0, 1.5)))
    fig = tvis.plot_training_log([str(log)], keys=("loss", "lr"),
                                 out_path=str(tmp_path / "p.png"))
    assert (tmp_path / "p.png").stat().st_size > 0
    assert [list(line.get_ydata()) for line in fig.axes[0].lines] == [[3.0, 2.0, 1.5]]

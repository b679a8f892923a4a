"""The detection cell ``detr_coco_b8`` on the CPU: its generator (the same
seed gives the same pool, the orientation shares, every call of one
orientation), its driver against the tiny model through the whole harness,
its two new readers on known answers, the yardstick's count of its
configuration against a hand count, and the limits' precision readings
(``benchmark/limits_precision.py``)."""

import json
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.generators import coco_requests
from benchmark.tests.tiny import TINY
from benchmark.yardstick import work

ROOT = harness.ROOT
MIX = json.loads((ROOT / "benchmark" / "traffic" / "coco_val_b8.json").read_text())
SMALL = {"sizes": [{"shape": "4:3 landscape", "h": 48, "w": 64, "requests": 7},
                   {"shape": "16:9", "h": 36, "w": 64, "requests": 2},
                   {"shape": "square", "h": 48, "w": 48, "requests": 2},
                   {"shape": "2:3 portrait", "h": 64, "w": 44, "requests": 5}],
         "buckets": [[48, 64], [64, 48]], "requests_per_call": 2, "cycle_calls": 8}
CELL = {"model": {**TINY, "num_query_position": 8},
        "traffic": SMALL,
        "cell": {"warmup_calls": 1, "profiled_calls": 3,
                 "check": {"sample_calls": 3, "sample_shapes": ["2:3 portrait", "16:9"],
                           "limits": {"logit_gap": 1e-4, "box_gap": 1e-4,
                                      "served_mismatch": 0}}}}


def test_pool_shares_and_buckets():
    sizes = [(s["h"], s["w"]) for s in MIX["sizes"] for _ in range(s["requests"])]
    assert len(sizes) == 192
    landscape, portrait = MIX["buckets"]
    assert landscape == [800, 1344] and portrait == [1344, 800]
    for h, w in sizes:
        assert min(h, w) == 800 or (h, w) == (750, 1333)  # short side 800, long <= 1333
        assert max(h, w) <= 1333
        bucket = portrait if h > w else landscape
        assert h <= bucket[0] and w <= bucket[1]
    assert sum(h > w for h, w in sizes) == 58  # 3:4 and 2:3 portraits, ~30%


def test_same_seed_same_pool():
    a = coco_requests.generate({**MIX, **SMALL}, 2**31 + 11, "cpu")
    b = coco_requests.generate({**MIX, **SMALL}, 2**31 + 11, "cpu")
    c = coco_requests.generate({**MIX, **SMALL}, 5, "cpu")
    assert len(a["requests"]) == 16 and a["schedule"] == b["schedule"]
    for (x,), (y,) in zip(a["requests"], b["requests"]):
        assert x.dtype == np.uint8 and np.array_equal(x, y)
    shapes = lambda t: sorted(r[0].shape for r in t["requests"])  # noqa: E731
    assert shapes(a) == shapes(c)  # every seed the same sizes, in its own order
    assert a["shapes"] != c["shapes"] or a["schedule"] != c["schedule"]


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_calls_are_of_one_orientation_at_the_pool_shares(seed):
    t = coco_requests.generate(MIX | {"sizes": [dict(s, h=s["h"] // 50, w=s["w"] // 50)
                                                for s in MIX["sizes"]]}, seed, "cpu")
    assert len(t["schedule"]) == 24 and sum(t["schedule"]) == 7  # round(24 * 58 / 192)
    taken = {0: [], 1: []}
    for c, idx in enumerate(coco_requests.calls(t, 0, 48)):
        side = coco_requests.orientation(t, c)
        assert len(idx) == 8
        assert {int(t["requests"][i][0].shape[0] > t["requests"][i][0].shape[1])
                for i in idx} == {side}
        taken[side] += idx
    # each orientation takes its pool in turn
    for side, idx in taken.items():
        members = t["groups"][side]
        assert idx == [members[j % len(members)] for j in range(len(idx))]
    assert coco_requests.calls(t, 30, 2) == coco_requests.calls(t, 0, 32)[30:]


def test_cell_runs_and_is_correct_on_the_cpu():
    res = harness.run_cell("detr_coco_b8", 2**31 + 7, 0.5, False, time.perf_counter(),
                           device="cpu", overrides=CELL)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "serve_img_per_s"}
    assert res["check"]["served_mismatch"]["value"] == 0
    traced = harness.run_cell("detr_coco_b8", 2**31 + 7, 0.2, True, time.perf_counter(),
                              device="cpu", overrides=CELL)
    assert traced["correct"] is True
    # on the CPU: no device events, so only the program's own spans and
    # counters read; the plain RCDA path launches no kernel
    assert {"topk_ms.detr", "real_px_pct.detr", "mfu.detr"} <= set(traced["metrics"])
    assert "rcda_cuda_core_pct.detr" not in traced["metrics"]


def test_sample_holds_a_portrait_and_a_16_9_call():
    from benchmark.drivers.detect_loop import Driver

    t = coco_requests.generate({**MIX, **SMALL}, 9, "cpu")
    d = Driver({}, SMALL, CELL["cell"], t, 9, "cpu")
    d.done = [(idx, None, None) for idx in coco_requests.calls(t, 0, 12)]
    picked = d.sample()
    assert len(picked) == 3 == len(set(picked))
    held = [{t["shapes"][i] for i in d.done[c][0]} for c in picked]
    assert any("2:3 portrait" in h for h in held) and any("16:9" in h for h in held)


def context(events=(), images=1):
    return harness.Context(model={}, dtype="float32", setup_s=0.0, window=harness.Window(),
                           trace=harness.Trace(events=list(events), range="bench_window",
                                               images=[(800, 1067, 300)] * images,
                                               requests=images))


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def test_topk_ms_reads_the_spans():
    read = harness.metric_reader("topk_ms.detr")
    events = [span("bench_window", 0, 1000), span("serve.topk", 100, 300),
              span("serve.topk", 600, 100), span("serve.topk", 1500, 50)]  # the last outside
    assert read(context(events)) == pytest.approx((300 + 100) / 2 / 1e3)
    assert read(context(events[:1])) is None


def test_rcda_cuda_core_pct_reads_the_counters():
    trace = pytest.importorskip("countdetr_tpu_torch.utils.trace")
    read = harness.metric_reader("rcda_cuda_core_pct.detr")
    before = trace.counters()
    try:
        trace.reset()
        assert read(context()) is None
        trace.count("launch.rcda", 12)
        assert read(context()) is None  # a program without the counter
        trace.count("launch.rcda_cuda_cores", 0)  # every launch on the tensor cores
        assert read(context()) == 0.0
        trace.count("launch.rcda_cuda_cores", 9)
        trace.count("launch.rcda_rank1", 6)
        assert read(context()) == pytest.approx(100 * 9 / 18)
    finally:
        trace.reset()
        for k, v in before.items():
            trace.count(k, v)


def test_forward_flops_hand_count():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "anchordetr_r50dc5_coco_f32.json")
                     .read_text())["model"]
    backbone, h5, w5 = work.backbone_macs(800, 1344)
    assert (h5, w5) == (50, 84)
    C, F, Q, HW, K = 256, 1024, 900, 50 * 84, 91
    macs = backbone
    macs += HW * 2048 * C  # input projection, 1x1 from C5
    macs += (50 + 84) * 2 * C * C  # the 1-D position MLP over rows and columns
    # six encoder RCDA: q_row, q_col, k_row, k_col, v projections on the grid, out
    macs += 6 * (2 * HW * C * C + 3 * HW * C * C + HW * C * C)
    macs += 6 * 2 * HW * C * F  # encoder FFNs
    macs += Q * 2 * C * C * 3  # the queries' 2-D and two 1-D position MLPs
    macs += 6 * 4 * Q * C * C  # decoder self-attention projections
    macs += 6 * (2 * Q * C * C + 3 * HW * C * C + Q * C * C)  # decoder RCDA projections
    macs += 6 * 2 * Q * C * F  # decoder FFNs
    macs += Q * (C * K + 2 * C * C + 4 * C)  # class head, box MLP
    cores = 6 * (2 * HW * C * (50 + 84) + 2 * HW * C * HW)  # encoder RCDA
    cores += 6 * (2 * Q * C * (50 + 84) + 2 * Q * C * HW)  # decoder RCDA
    cores += 6 * 4 * Q * Q * C  # decoder MHA
    assert work.num_queries(cfg, 300) == Q
    assert work.forward_flops(cfg, 800, 1344, 300) == pytest.approx(2 * macs + cores, rel=1e-12)
    assert 4.0e11 < 2 * macs + cores < 4.2e11  # 411 GFLOP an image


@pytest.mark.parametrize("mode", ["sound", "tf32", "bf16"])
def test_precision_readings_run_and_restore(mode):
    """The limits' readings in each mode at the tiny width on the CPU (where
    TF32 and the kernels do not exist, so every mode is sound there); the
    harness and the RCDA dispatch are restored after."""
    from benchmark import limits_precision
    from countdetr_tpu_torch.ops.kernels import rcda_kernel

    before = (harness.set_precision, rcda_kernel._rcda_forward)
    got = list(limits_precision.readings("detr_coco_b8", mode, [3], 0.2, "cpu", CELL))
    assert (harness.set_precision, rcda_kernel._rcda_forward) == before
    (seed, res), = got
    assert seed == 3 and res["attempted"] > 0 and res["failed"] == 0
    assert res["check"]["served_mismatch"]["value"] == 0
    with pytest.raises(ValueError, match="mode"):
        with limits_precision.precision("fp8"):
            pass

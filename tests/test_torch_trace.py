"""The port's spans and counters (``countdetr_tpu_torch/utils/trace.py``), on
the CPU: a tiny stage-2 ``Predictor`` under torch.profiler gives the
serving path's spans, nested as the benchmark's readers expect; with no
profiler a span builds nothing; the pixel counters are exact; the launch
counters read and reset as the kernel wrappers' module counters did."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from countdetr_tpu_torch.config import stage2_config
from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
from countdetr_tpu_torch.serve import Predictor, pack_requests
from countdetr_tpu_torch.utils import trace

TINY = dict(enc_layers=1, dec_layers=2, hidden_dim=32, nheads=4, dim_feedforward=64,
            num_query_position=25)
BUCKET = (64, 64)
# (h, w): three fit the bucket, the last is downscaled to 64 x 38
SIZES = ((64, 64), (50, 38), (30, 61), (80, 48))
PX_REAL = 64 * 64 + 50 * 38 + 30 * 61 + 64 * 38
SERVE = ("serve.pack", "serve.h2d", "serve.model", "serve.d2h", "serve.count")


def requests(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        xy = rng.uniform(0.1, 0.6, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (3, 2))], 1)
        out.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), boxes.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def predictor():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield Predictor(stage2_config(**TINY), device="cpu", bucket=BUCKET, seed=0)
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_counters():
    trace.reset()
    yield
    trace.reset()


def annotations(prof, tmp_path):
    """The profile's user_annotation events as (name, start, end, tid),
    read back from its Chrome trace as the benchmark reads them."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def prefix(name):
    return name.split(" ", 1)[0]


def inside(child, parent):
    return child[3] == parent[3] and parent[1] <= child[1] and child[2] <= parent[2]


@pytest.fixture(scope="module")
def traced(predictor, tmp_path_factory):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = predictor.predict(requests())
    return results, annotations(prof, tmp_path_factory.mktemp("trace"))


def test_predict_spans_nest(traced):
    results, spans = traced
    assert len(results) == len(SIZES)
    (call,) = [s for s in spans if s[0] == "serve.predict"]
    for name in SERVE:
        (s,) = [s for s in spans if s[0] == name]
        assert inside(s, call), name
    starts = [next(s[1] for s in spans if s[0] == name) for name in SERVE]
    assert starts == sorted(starts)
    (model,) = [s for s in spans if s[0] == "serve.model"]
    (backbone,) = [s for s in spans if s[0] == "model.backbone"]
    assert inside(backbone, model)


def test_core_spans_carry_their_shape(traced):
    _, spans = traced
    (model,) = [s for s in spans if s[0] == "serve.model"]
    cores = [s for s in spans if s[0].startswith("core.")]
    # one encoder layer (its RCDA), two decoder layers (an MHA and an RCDA each)
    assert sorted(prefix(s[0]) for s in cores) == ["core.mha"] * 2 + ["core.rcda"] * 3
    assert all(inside(s, model) for s in cores)
    rcda = {s[0] for s in cores if prefix(s[0]) == "core.rcda"}
    assert "core.rcda B=4 L=16 4x4 float32" in rcda, rcda
    assert {s[0] for s in cores if prefix(s[0]) == "core.mha"} == \
        {"core.mha B=4 L=25 S=25 float32"}


@pytest.mark.parametrize("variant", ["v3", "rank1"])
def test_rcda_and_auction_spans_on_the_plain_path(variant, tmp_path):
    f = lambda *s: torch.randn(*s)  # noqa: E731
    args = (f(2, 12, 32), f(2, 12, 32), f(2, 5, 32), f(2, 4, 32), f(2, 4, 5, 32),
            torch.zeros(2, 5), torch.zeros(2, 4))
    benefit, active = torch.rand(2, 6, 9), torch.ones(2, 6, dtype=torch.bool)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rcda_kernel.rcda_core(*args, 2, variant)
        auction_kernel.auction_assign(benefit, active, torch.full((2,), 1e-3), 100)
    names = {s[0] for s in annotations(prof, tmp_path)}
    core = "core.rcda_rank1" if variant == "rank1" else "core.rcda"
    assert names == {f"{core} B=2 L=12 4x5 float32", "core.auction 2x6x9"}
    assert trace.launch_counts() == dict.fromkeys(trace.LAUNCHES, 0)


def test_predict_calls_forward_and_uses_its_dict(monkeypatch):
    pred = Predictor(stage2_config(**TINY), device="cpu", bucket=BUCKET, seed=0)
    forward, calls = pred.forward, []

    def wrapped(*args, **kw):
        calls.append((args, kw))
        out = forward(*args, **kw)
        out["pred_logits"] = torch.full_like(out["pred_logits"], -10.0)
        out["pred_boxes"] = torch.full_like(out["pred_boxes"], 0.25)
        return out

    monkeypatch.setattr(pred, "forward", wrapped)
    reqs = requests()
    results = pred.predict(reqs)
    assert len(calls) == 1
    args, kw = calls[0]
    assert len(args) == 5 and not kw and args[3] is None and args[4] is None
    assert args[0].shape == (len(SIZES), 32, 32, 12)
    for (image, _), r in zip(reqs, results):
        h, w = image.shape[:2]
        # every score under 0.5 keeps every query (the counting rule's quirk)
        assert r["count"] == r["boxes_cxcywh_px"].shape[0] == 25
        np.testing.assert_allclose(r["boxes_cxcywh_px"], np.tile([[w, h, w, h]], (25, 1)) * 0.25,
                                   rtol=1e-6)


def test_span_off_builds_no_record_function(predictor, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span built a RecordFunction with no profiler running")

    def no_shape():
        raise AssertionError("a span formatted its shape with no profiler running")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("serve.pack") is trace.span("core.rcda", no_shape)
    with trace.span("core.rcda", no_shape):
        pass
    assert len(predictor.predict(requests(1))) == len(SIZES)


def test_span_on_names_the_range(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("core.mha", lambda: "B=1 L=2 S=3 float32"):
                pass
    spans = annotations(prof, tmp_path)
    (outer,) = [s for s in spans if s[0] == "outer"]
    (inner,) = [s for s in spans if s[0] == "core.mha B=1 L=2 S=3 float32"]
    assert inside(inner, outer)


@pytest.mark.parametrize("sizes, real", [
    (SIZES, PX_REAL),
    (((64, 64),), 64 * 64),
    (((128, 64),), 64 * 32),  # downscaled by 2
    (((10, 200),), 3 * 64),  # downscaled by 0.32 to 3 x 64
])
def test_pixel_counters_are_exact(sizes, real):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), np.zeros((3, 4), np.float32))
            for h, w in sizes]
    _, masks, _, _ = pack_requests(reqs, BUCKET)
    got = trace.counters()
    assert got == {"serve.px_real": real, "serve.px_bucket": len(sizes) * 64 * 64}
    assert got["serve.px_real"] == int((~masks).sum())
    pack_requests(reqs, BUCKET)
    assert trace.counters()["serve.px_real"] == 2 * real


def test_launch_counters():
    assert trace.launch_counts() == {"rcda": 0, "rcda_rank1": 0, "mha": 0, "auction": 0}
    for name, n in (("launch.rcda", 3), ("launch.rcda_rank1", 1), ("launch.mha", 2),
                    ("launch.auction", 1), ("launch.rcda", 1), ("serve.px_real", 7)):
        trace.count(name, n)
    assert trace.launch_counts() == {"rcda": 4, "rcda_rank1": 1, "mha": 2, "auction": 1}
    copy = trace.counters()
    copy["launch.mha"] = 99
    assert trace.launch_counts()["mha"] == 2
    trace.reset_launches()
    assert trace.launch_counts() == dict.fromkeys(trace.LAUNCHES, 0)
    assert trace.counters() == {"serve.px_real": 7}
    trace.reset()
    assert trace.counters() == {}


def test_wrappers_hold_no_module_counters():
    for mod in (rcda_kernel, mha_kernel, auction_kernel):
        assert not hasattr(mod, "launches") and not hasattr(mod, "rank1_launches")


def test_counts_from_many_threads_add_up():
    import os
    import sys
    import threading

    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [trace.count("launch.mha") for _ in range(n)])
                   for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert trace.launch_counts()["mha"] == n_threads * n

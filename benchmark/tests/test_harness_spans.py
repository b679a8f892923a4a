"""The readers of the program's spans and counters
(``benchmark/yardstick/spans.py`` and the metric files that bind them) on
canned Chrome-trace events with known answers: two predict calls, their
spans, the launches that link each device event to its span, a launch on
another thread and one outside every span; and two stage-1 forwards of a
pseudo-label pass, the same way."""

import dataclasses

import pytest

from benchmark import harness
from benchmark.yardstick import readers, spans


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "tid": tid,
            "args": {"correlation": corr}}


def device(corr, ts, end, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [
    span("bench_window", 0, 1000),
    # call 1
    span("serve.predict", 10, 480),
    span("serve.pack", 10, 90),
    span("serve.h2d", 100, 20),
    span("serve.model", 120, 180),
    span("model.backbone", 125, 75),
    span("core.rcda B=32 L=1369 37x37 float32", 210, 20),
    span("core.mha B=32 L=576 S=576 float32", 240, 10),
    span("serve.d2h", 300, 100),
    span("serve.count", 400, 80),
    launch(1, 105), device(1, 110, 130, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"),
    launch(2, 130), device(2, 140, 200),
    launch(3, 150), device(3, 200, 260),
    launch(4, 215), device(4, 260, 300, name="rcda_tf32_kernel"),
    launch(5, 245), device(5, 300, 320, name="mha_tf32_kernel"),
    launch(6, 205), device(6, 320, 340),  # in serve.model, in no backbone or core span
    launch(7, 220, tid=2), device(7, 340, 350),  # in core.rcda's time, on another thread
    launch(8, 305), device(8, 350, 355, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)"),
    # call 2
    span("serve.predict", 500, 490),
    span("serve.pack", 500, 120),
    span("serve.h2d", 620, 20),
    span("serve.model", 640, 160),
    span("model.backbone", 650, 50),
    span("serve.d2h", 800, 100),
    span("serve.count", 900, 80),
    launch(9, 625), device(9, 630, 650, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"),
    launch(10, 660, cat="cuda_driver"), device(10, 700, 800),
    launch(11, 805), device(11, 850, 860, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)"),
    launch(12, 690), device(12, 1100, 1110),  # runs after the window closed
    # outside the window
    span("serve.pack", 1200, 500),
]
IMAGES = 4
# busy union (110,130) (140,355) (630,650) (700,800) (850,860): 365 us in an
# envelope of 750; gaps (130,140) (355,630) (650,700) (800,850): 385 us, of
# which 375 inside serve.predict and 60 of those inside serve.model
ENVELOPE, IDLE = 750.0, 385.0
ANSWERS = {
    "pack_ms.serve": (90 + 120) / 2 / 1e3,
    "h2d_ms.serve": 20 / 1e3,
    "model_issue_ms.single": (180 + 160) / 2 / 1e3,
    "entry_idle_pct.serve": 100 * (375 - 60) / ENVELOPE,
    "entry_idle_pct.single": 100 * (375 - 60) / ENVELOPE,
    "backbone_device_ms.serve": (60 + 60 + 100) / IMAGES / 1e3,
    "attn_device_ms.serve": (40 + 20) / IMAGES / 1e3,
}

# a stage-1 pass: two batches' forwards in the pseudo-label driver's
# ``model_forward`` ranges, each with the attention cores' spans inside
PSEUDO_EVENTS = [
    span("bench_window", 0, 2000),
    span("model_forward", 100, 400),
    span("core.rcda B=8 L=1008 24x42 float32", 150, 30),
    span("core.rcda_rank1 B=8 L=700 24x42 float32", 200, 20),
    span("core.mha B=8 L=700 S=700 float32", 250, 20),
    launch(21, 120), device(21, 130, 170),  # in model_forward, in no core span
    launch(22, 160), device(22, 180, 220, name="rcda_tf32_kernel"),
    launch(23, 210), device(23, 220, 240, name="rcda_tf32_kernel"),
    launch(24, 255), device(24, 260, 290, name="mha_tf32_kernel"),
    launch(25, 262, tid=2), device(25, 290, 300),  # in core.mha's time, on another thread
    launch(26, 600), device(26, 610, 700),  # the host loop between the forwards
    span("model_forward", 1000, 300),
    span("core.mha B=8 L=5600 S=5600 float32", 1100, 50),
    launch(27, 1110), device(27, 1150, 1250, name="mha_tf32_kernel"),
    launch(28, 1140), device(28, 2100, 2110),  # runs after the window closed
    # outside the window
    span("model_forward", 2500, 100),
]
PSEUDO_IMAGES = 16
PSEUDO_ANSWERS = {
    "model_issue_ms.pseudo": (400 + 300) / 2 / 1e3,
    # (180, 240) merged, (260, 290), (1150, 1250)
    "attn_device_ms.pseudo": (60 + 30 + 100) / PSEUDO_IMAGES / 1e3,
}
NEW = tuple(ANSWERS) + tuple(PSEUDO_ANSWERS) + ("real_px_pct.serve",)


def context(events=EVENTS, images=IMAGES):
    return harness.Context(model={}, dtype="float32", setup_s=0.0, window=harness.Window(),
                           trace=harness.Trace(events=list(events), range="bench_window",
                                               images=[(64, 64, 0)] * images,
                                               requests=images))


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_reader_reads_the_known_answer(name):
    assert harness.metric_reader(name)(context()) == pytest.approx(ANSWERS[name])


@pytest.mark.parametrize("name", sorted(PSEUDO_ANSWERS))
def test_pseudo_reader_reads_the_known_answer(name):
    ctx = context(PSEUDO_EVENTS, PSEUDO_IMAGES)
    assert harness.metric_reader(name)(ctx) == pytest.approx(PSEUDO_ANSWERS[name])


def test_new_metrics_are_in_the_manifest():
    entries = {m["name"]: m for m in harness.manifest()["per_layer"]}
    cells = {"single": "s2_serve_b1", "serve": "s2_serve_b32", "pseudo": "s1_pseudo_fsc147"}
    for name in NEW:
        cell = cells[name.rsplit(".", 1)[1]]
        assert entries[name]["workloads"] == [cell]
        source = {"real_px_pct.serve": "program_counter",
                  "model_issue_ms.pseudo": "host_clock"}.get(name, "program_span")
        assert entries[name]["source"] == source


def test_entry_and_model_idle_within_idle_pct():
    ctx = context()
    gaps, envelope = spans.idle_gaps(ctx)
    assert envelope == ENVELOPE and spans.length(gaps) == IDLE
    assert readers.idle_pct(ctx) == pytest.approx(100 * IDLE / ENVELOPE)
    model_idle = spans.idle_share(ctx, "serve.model")
    assert model_idle == pytest.approx(100 * 60 / ENVELOPE)
    assert spans.entry_idle_pct(ctx) + model_idle <= readers.idle_pct(ctx)


def test_device_time_by_span_within_device_ms_per_img():
    ctx = context()
    backbone = harness.metric_reader("backbone_device_ms.serve")(ctx)
    attn = harness.metric_reader("attn_device_ms.serve")(ctx)
    assert backbone + attn <= readers.device_ms_per_img(ctx)


def test_correlation_matching_ignores_launches_outside_the_span():
    ctx = context()
    corr = lambda found: sorted(e["args"]["correlation"] for e in found)  # noqa: E731
    # 6 was launched in serve.model outside its backbone and cores, 7 on
    # another thread, 12's kernel ran after the window
    assert corr(spans.launched_in(ctx, ("model.backbone",))) == [2, 3, 10]
    assert corr(spans.launched_in(ctx, ("core.rcda", "core.rcda_rank1", "core.mha"))) == [4, 5]
    assert corr(spans.launched_in(ctx, ("serve.h2d",))) == [1, 9]
    assert corr(spans.launched_in(ctx, ("serve.model",))) == [2, 3, 4, 5, 6, 10]


def test_idle_gaps_go_to_the_spans():
    labels = dict(readers.breakdown(context())["idle_gaps"])
    assert labels == {"model.backbone": pytest.approx(60e-6), "python": pytest.approx(275e-6),
                      "serve.d2h": pytest.approx(50e-6)}


@pytest.mark.parametrize("name", NEW)
def test_reader_without_spans_is_none(name, monkeypatch):
    import sys

    monkeypatch.delitem(sys.modules, "countdetr_tpu_torch.utils.trace", raising=False)
    monkeypatch.setitem(sys.modules, "countdetr_tpu_torch.utils.trace", None)
    pkg = sys.modules.get("countdetr_tpu_torch.utils")
    if pkg is not None and hasattr(pkg, "trace"):
        monkeypatch.delattr(pkg, "trace")
    bare = [e for e in EVENTS if e.get("cat") != "user_annotation" or e["name"] == "bench_window"]
    read = harness.metric_reader(name)
    assert read(context(bare)) is None
    assert read(dataclasses.replace(context(), trace=None)) is None


def test_real_px_pct_reads_the_counters():
    trace = pytest.importorskip("countdetr_tpu_torch.utils.trace")
    read = harness.metric_reader("real_px_pct.serve")
    before = trace.counters()
    try:
        trace.reset()
        assert read(context()) is None
        trace.count("serve.px_bucket", 592 * 592)
        assert read(context()) is None
        trace.count("serve.px_real", 488 * 488)
        assert read(context()) == pytest.approx(100 * 488 ** 2 / 592 ** 2)
    finally:
        trace.reset()
        for k, v in before.items():
            trace.count(k, v)

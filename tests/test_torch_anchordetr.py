"""Anchor DETR R50-DC5 on the port's serving path, on the CPU: a stage-1
model under the learned prior (anchor points x 3 patterns, 91 classes)
against the benchmark's plain reference (``benchmark/reference/
anchor_detr.py``, ``topk.py``) on seeded random weights, at the published
widths on small images (96 x 160, a 6 x 10 grid); ``Predictor``'s buckets,
its staging with no boxes and its top-k results; a stage-2 predictor's
results under a tuple of buckets. The tests marked ``cuda`` run rcda.cu's
float32 kernels, the 3xTF32 one at the COCO grids and at its chunks' edges,
the CUDA-core one where the tensor cores do not reach, and skip without a
card. No JAX here."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import anchor_detr, topk
from countdetr_tpu_torch.config import ModelConfig, stage2_config
from countdetr_tpu_torch.ops.kernels import rcda_kernel
from countdetr_tpu_torch.serve import (Predictor, pick_bucket, stage_requests, staged_views,
                                       staging_layout)
from countdetr_tpu_torch.utils import trace

W = {"cls_logit_std": 1.0, "cls_bias": -4.59511985013459}
# the published widths (ResNet-50-DC5, 256 wide, 8 heads, 6 + 6 layers, FFN
# 1024, 91 classes, 3 patterns) with 8 anchor points in place of 300
DETR = ModelConfig(stage=1, spatial_prior="learned", num_query_position=8,
                   num_query_pattern=3, num_classes=91)
BUCKETS = ((96, 160), (160, 96))
TINY = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64)


@pytest.fixture(autouse=True)
def clean_counters():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def detr():
    """(state, predictor) at the published widths, the reference's draw
    loaded by the port."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    state = anchor_detr.draw(dataclasses.asdict(DETR), W, 2**31 + 21, "cpu")
    yield state, Predictor(DETR, state_dict=state, device="cpu", bucket=BUCKETS)
    torch.set_num_threads(threads)


def images(sizes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),) for h, w in sizes]


def captured_predict(pred, reqs, monkeypatch):
    """``pred.predict(reqs)``, with the forward's arguments and outputs."""
    forward, seen = pred.forward, {}

    def wrapped(*args, **kw):
        seen["args"] = args
        seen["out"] = forward(*args, **kw)
        return seen["out"]

    monkeypatch.setattr(pred, "forward", wrapped)
    return pred.predict(reqs), seen["args"], seen["out"]


def test_spec_is_the_program_state_dict():
    from countdetr_tpu_torch.models.anchor_detr import CountingDetr

    sd = CountingDetr(DETR).state_dict()
    spec = {k: s for k, s, _ in anchor_detr.param_spec(dataclasses.asdict(DETR))}
    assert spec == {k: tuple(v.shape) for k, v in sd.items()}
    pos = anchor_detr.draw(dataclasses.asdict(DETR), W, 5, "cpu")[anchor_detr.POSITION]
    assert pos.shape == (8, 2) and 0 < pos.min() and pos.max() < 1


@pytest.mark.parametrize("sizes, bucket", [
    (((96, 160), (80, 150)), (96, 160)),  # landscape, one image padded
    (((160, 96), (150, 64)), (160, 96)),  # portrait: a 10 x 6 grid
])
def test_forward_matches_the_reference(detr, sizes, bucket, monkeypatch):
    state, pred = detr
    reqs = images(sizes, seed=sizes[1][1])
    _, args, out = captured_predict(pred, reqs, monkeypatch)
    assert tuple(args[1].shape[1:]) == bucket
    ref = anchor_detr.run(state, dataclasses.asdict(DETR),
                          [{"image": r[0], "bucket": bucket} for r in reqs], "cpu")
    boxes = torch.cat([out["pred_points"], out["pred_wh"]], dim=-1)
    assert out["pred_logits"].shape == (2, 24, 91) and boxes.shape == (2, 24, 4)
    # Both sides are float32 on the CPU and compute the same products; they
    # differ only in the order of sums (the port's fused projections, the
    # plain RCDA core's einsums), a few float32 ulps of logits of |x| < 8
    # after 12 layers (1.9e-6 read) and of boxes in (0, 1) (2.4e-7 read).
    for j in range(2):
        np.testing.assert_allclose(out["pred_logits"][j].numpy(), ref[j]["pred_logits"],
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(boxes[j].numpy(), ref[j]["pred_boxes"], atol=5e-6, rtol=0)


def test_predict_buckets_stages_no_boxes_and_serves_the_top_k(detr, monkeypatch):
    _, pred = detr
    cases = [(((80, 150), (96, 96)), (48, 80)),  # landscape and square
             (((150, 64), (120, 90)), (80, 48)),  # portrait
             (((96, 96), (64, 64)), (48, 80))]  # square only: both fit, the first listed
    for sizes, packed in cases:
        reqs = images(sizes, seed=len(sizes) + sizes[0][0])
        results, args, out = captured_predict(pred, reqs, monkeypatch)
        assert tuple(args[0].shape) == (2, *packed, 12)
        assert tuple(args[2].shape) == (2, 0, 4) and args[3] is None and args[4] is None
        boxes = torch.cat([out["pred_points"], out["pred_wh"]], dim=-1)
        want = topk.served(out["pred_logits"], boxes, [(w, h) for h, w in sizes])
        for got, w in zip(results, want):
            assert set(got) == {"scores", "labels", "boxes_xyxy_px"}
            assert got["scores"].shape == (100,) and got["boxes_xyxy_px"].shape == (100, 4)
            assert topk.same(got, w)
            assert (got["labels"] >= 0).all() and (got["labels"] < 91).all()
            assert (np.diff(got["scores"]) <= 0).all()


def test_staging_with_no_boxes():
    boxes = np.zeros((2, 0, 4), np.float32)
    boxes_at, images_at, size = staging_layout(2, 0, (64, 96))
    assert boxes_at == images_at == 48 and size == 48 + 2 * 64 * 96 * 3
    buf = torch.zeros(size, dtype=torch.uint8)
    reqs = images(((64, 96), (30, 50)), seed=3)
    used, sizes = stage_requests(buf, reqs, boxes, (64, 96))
    table, staged = staged_views(buf, 2, 0, (64, 96))
    assert tuple(staged.shape) == (2, 0, 4) and sizes == [(96, 64), (50, 30)]
    assert table.tolist() == [[48, 64, 96], [48 + 64 * 96 * 3, 30, 50]]
    assert used == 48 + 64 * 96 * 3 + 30 * 50 * 3 + 12  # the last image ends 16-byte aligned


def test_pick_bucket():
    two = ((800, 1344), (1344, 800))
    assert pick_bucket([(800, 1067), (750, 1333)], two) == (800, 1344)
    assert pick_bucket([(1199, 800), (1067, 800)], two) == (1344, 800)
    assert pick_bucket([(800, 800)], two) == (800, 1344)  # equal areas: the first listed
    assert pick_bucket([(800, 800)], two[::-1]) == (1344, 800)
    assert pick_bucket([(700, 700)], ((1344, 800), (768, 768))) == (768, 768)  # the smallest
    # none holds both: the largest (the larger images downscaled into it)
    assert pick_bucket([(800, 1067), (1067, 800)], two) == (800, 1344)
    assert pick_bucket([(2000, 2000)], ((592, 592),)) == (592, 592)  # one bucket: always it


def test_stage2_results_unchanged_by_the_bucket_tuple():
    cfg = stage2_config(**TINY, num_query_position=25)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
             np.array([[0.1, 0.1, 0.3, 0.3]] * 3, np.float32)) for h, w in ((64, 64), (40, 56))]
    results = [Predictor(cfg, device="cpu", bucket=b, seed=0).predict(reqs)
               for b in ((64, 64), ((64, 64),), ((96, 96), (64, 64)), [[64, 64], [64, 96]])]
    for other in results[1:]:
        for got, want in zip(other, results[0]):
            assert got["count"] == want["count"] and got["threshold"] == want["threshold"]
            np.testing.assert_array_equal(got["boxes_cxcywh_px"], want["boxes_cxcywh_px"])
            np.testing.assert_array_equal(got["scores"], want["scores"])


def test_detector_call_spans():
    pred = Predictor(ModelConfig(**TINY, num_query_position=4, num_classes=91), device="cpu",
                     bucket=BUCKETS, seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict(images(((96, 160),), seed=8))
    names = {e.name for e in prof.events()}
    assert {"serve.predict", "serve.pack", "serve.h2d", "serve.model", "serve.topk"} <= names
    assert not {"serve.d2h", "serve.count"} & names
    assert trace.counters() == {"serve.px_real": 96 * 160, "serve.px_bucket": 96 * 160}


# rcda.cu's 3xTF32 kernel against rcda_core_plain in float32: the CPU
# tolerance of its arithmetic against the JAX package
# (test_torch_f32_tensor_cores.py's RCDA_TOL, a file that imports JAX)
RCDA_TOL = 2e-5


def f32_rcda_case(H, W, L, E=256, n=8, pad=None):
    """rcda.cu's float32 route on a card against ``rcda_core_plain`` (TF32
    off) for B = 2, image 1 padded to ``pad`` (columns, rows; by default
    5 / 7 of each axis): (largest error, ``launch.rcda_cuda_cores``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RCDA kernel has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device="cuda").manual_seed(H * W + L + E)
        r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
        B, d = 2, E // n
        args = [r(B, L, E) * d**-0.5, r(B, L, E) * d**-0.5, r(B, W, E), r(B, H, E),
                r(B, H, W, E), torch.zeros(B, W, device="cuda"),
                torch.zeros(B, H, device="cuda")]
        cols, rows = pad or (W * 5 // 7, H * 5 // 7)
        args[5][1, cols:] = -1e30
        args[6][1, rows:] = -1e30
        trace.reset_launches()
        got = rcda_kernel.rcda_core(*args, n)
        torch.cuda.synchronize()
        assert trace.launch_counts()["rcda"] == 1
        want = rcda_kernel.rcda_core_plain(*args, n)
        assert torch.isfinite(got).all()
        return (got - want).abs().max().item(), trace.counters()["launch.rcda_cuda_cores"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("L", ["HW", 900])
@pytest.mark.parametrize("H, W", [(50, 84), (84, 50)])
def test_f32_rcda_on_the_tensor_cores_at_the_coco_grids(H, W, L):
    """The COCO detector's C5 grids take rcda.cu's 3xTF32 kernel in two
    64-wide chunks: the encoder's L = H W and the decoder's 900 queries,
    image 1 padded as an 800 x 1067 image is in the 800 x 1344 bucket (and
    turned, in 1344 x 800), within the 3xTF32 tolerance, no launch on the
    CUDA cores."""
    assert rcda_kernel.f32_route(H, W, 32) == "tensor_cores"
    pad = (67, H) if W > H else (W, 67)
    err, cuda_cores = f32_rcda_case(H, W, H * W if L == "HW" else L, pad=pad)
    assert cuda_cores == 0
    assert err <= RCDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, L, E", [
    (64, 64, 300, 256),    # the widest grid of one chunk
    (65, 40, 300, 256),    # a second chunk of one row (columns side)
    (40, 65, 300, 256),    # a second chunk of one column (rows side)
    (128, 128, 300, 256),  # the widest grid the kernel takes, both sides in two chunks
    (50, 84, 1000, 128),   # d = 16
    (84, 50, 130, 256),    # L not a multiple of 64: a ragged last query tile
])
def test_f32_rcda_tensor_core_chunks(H, W, L, E):
    assert rcda_kernel.f32_route(H, W, E // 8) == "tensor_cores"
    err, cuda_cores = f32_rcda_case(H, W, L, E)
    assert cuda_cores == 0
    assert err <= RCDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, E, n", [(37, 37, 256, 4), (136, 80, 256, 8)])
def test_f32_rcda_on_the_cuda_cores(H, W, E, n):
    """rcda.cu's CUDA-core kernel where the tensor cores do not reach, d =
    64 and an axis past 128: each launch counted in
    ``launch.rcda_cuda_cores``, against the plain core within the chip
    smoke test's float32 RCDA tolerance (both float32 sums, in another
    order)."""
    assert rcda_kernel.f32_route(H, W, E // n) == "cuda_cores"
    err, cuda_cores = f32_rcda_case(H, W, 900, E, n)
    assert cuda_cores == 1
    assert err < 1e-4

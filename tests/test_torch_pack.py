"""Serving's pack on the device (``ops/kernels/pack_kernel.py``) and the
``Predictor``'s staging (``serve.py::stage_requests``) against the host
pack, ``pack_requests``: bit for bit, on mixed sizes within one batch.

The CPU tests run the plain path the CPU ``Predictor`` takes; the tests
marked ``cuda`` run the kernel and skip without a card. No JAX here."""

import numpy as np
import pytest
import torch

from countdetr_tpu_torch.config import stage2_config
from countdetr_tpu_torch.ops.kernels import pack_kernel
from countdetr_tpu_torch.serve import (Predictor, pack_requests, request_boxes, stage_requests,
                                       staged_views, staging_layout)
from countdetr_tpu_torch.utils import trace

TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64,
            num_query_position=25)
# the serve_b32 pool's sides (benchmark/traffic/serve_b32.json)
POOL_SIDES = range(384, 577, 32)
CASES = {
    # 32 of the pool's sizes in its 592 bucket
    "pool": ((592, 592), [(int(h), int(w)) for h, w in
                          np.random.default_rng(5).choice(POOL_SIDES, (32, 2))]),
    # odd sides, the bucket's own size, 1x1, one row and column, and two
    # larger than the bucket (downscaled to 64x38 and 3x64)
    "odd": ((64, 64), [(63, 33), (64, 64), (1, 1), (17, 64), (64, 1), (80, 48), (10, 200)]),
    "wide": ((96, 128), [(95, 127), (96, 128), (3, 5), (41, 128), (96, 77)]),
}


def make_requests(sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        xy = rng.uniform(0.1, 0.6, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (3, 2))], 1).astype(np.float32)
        out.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), boxes))
    return out


def resized(sizes, bucket):
    return sum(h > bucket[0] or w > bucket[1] for h, w in sizes)


def staged_on(reqs, bucket, device):
    """The requests staged as ``Predictor`` stages them: (the buffer on
    ``device``, its (B, 3) table there)."""
    boxes = request_boxes(reqs)
    buf = torch.zeros(staging_layout(*boxes.shape[:2], bucket)[2], dtype=torch.uint8)
    stage_requests(buf, reqs, boxes, bucket)
    staged = buf.to(device)
    return staged, staged_views(staged, *boxes.shape[:2], bucket)[0]


@pytest.fixture(autouse=True)
def clean_counters():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def predictor():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield Predictor(stage2_config(**TINY), device="cpu", bucket=(64, 64), seed=0)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_staging_and_plain_pack_equal_pack_requests(case):
    bucket, sizes = CASES[case]
    reqs = make_requests(sizes, seed=len(sizes))
    images, masks, boxes, want_sizes = pack_requests(reqs, bucket)
    host_counters = trace.counters()
    trace.reset()
    staged, table = staged_on(reqs, bucket, "cpu")
    want = dict(host_counters)
    if resized(sizes, bucket):
        want["serve.pack_resized"] = resized(sizes, bucket)
    assert trace.counters() == want
    got_images, got_masks = pack_kernel.pack_images(staged, table, bucket)
    assert got_images.dtype == torch.uint8 and got_masks.dtype == torch.bool
    np.testing.assert_array_equal(got_images.numpy(), images)
    np.testing.assert_array_equal(got_masks.numpy(), masks)
    assert trace.launch_counts()["pack"] == 0  # the plain path launches nothing


@pytest.mark.parametrize("case", sorted(CASES))
def test_predictor_stages_what_pack_requests_packs(case):
    bucket, sizes = CASES[case]
    pred = Predictor(stage2_config(**TINY), device="cpu", bucket=bucket, seed=0)
    reqs = make_requests(sizes, seed=1 + len(sizes))
    images, masks, boxes, want_sizes = pack_requests(reqs, bucket)
    trace.reset()
    used, boxes_shape, got_sizes = pred._stage(reqs)
    assert got_sizes == want_sizes and boxes_shape == boxes.shape
    assert trace.counters().get("serve.pack_resized", 0) == resized(sizes, bucket)
    got = pred._upload(used, boxes_shape)
    for g, w in zip(got, (images, masks, boxes)):
        assert g.device == pred.device
        np.testing.assert_array_equal(g.numpy(), w)


def capture_forward(pred, monkeypatch):
    """Wrap ``pred.forward``; returns the list of each call's arguments."""
    forward, calls = pred.forward, []

    def wrapped(*args, **kw):
        calls.append([a if a is None else a.clone() for a in args])
        return forward(*args, **kw)

    monkeypatch.setattr(pred, "forward", wrapped)
    return calls


@pytest.mark.parametrize("sizes", [
    [(64, 64)] * 31 + [(1, 1)],  # B=32, then B=1, then B=32 of other sizes
    [(40, 40)] * 32,
])
def test_buffer_reused_across_calls_shows_no_stale_pixels(monkeypatch, sizes):
    predictor = Predictor(stage2_config(**TINY), device="cpu", bucket=(64, 64), seed=0)
    calls = capture_forward(predictor, monkeypatch)
    dispatches = []
    pack = pack_kernel.pack_images
    monkeypatch.setattr(pack_kernel, "pack_images",
                        lambda *a: dispatches.append(1) or pack(*a))
    batches = [make_requests(sizes, seed=20), make_requests([(5, 3)], seed=21),
               make_requests([(int(h), int(w)) for h, w in
                              np.random.default_rng(22).integers(1, 65, (32, 2))], seed=23)]
    buffers = []
    for reqs in batches:
        results = predictor.predict(reqs)
        assert len(results) == len(reqs)
        buffers.append(predictor._host.data_ptr())
    assert len(calls) == len(batches) == len(dispatches)  # one forward, one pack a call
    assert len(set(buffers)) == 1  # the first B=32 call sized the buffer for every later one
    for args, reqs in zip(calls, batches):
        assert len(args) == 5 and args[3] is None and args[4] is None
        for got, want in zip(args[:3], pack_requests(reqs, predictor.bucket)[:3]):
            np.testing.assert_array_equal(got.numpy(), want)
    assert trace.counters().get("serve.pack_resized", 0) == 0
    assert trace.launch_counts()["pack"] == 0


@pytest.mark.parametrize("view", ["flipped", "cropped", "read-only"])
def test_staging_takes_images_of_any_layout(view):
    """A request image may be any uint8 HWC array: a view with negative or
    gapped strides, or one numpy marks read-only."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (60, 62, 3), dtype=np.uint8)
    image = {"flipped": base[::-1, :, ::-1], "cropped": base[5:50:2, 3:60],
             "read-only": base.copy()}[view]
    image.flags.writeable = view != "read-only"
    reqs = [(image, np.zeros((3, 4), np.float32)), (base, np.zeros((3, 4), np.float32))]
    staged, table = staged_on(reqs, (64, 64), "cpu")
    images, masks, _, _ = pack_requests(reqs, (64, 64))
    got = pack_kernel.pack_images(staged, table, (64, 64))
    np.testing.assert_array_equal(got[0].numpy(), images)
    np.testing.assert_array_equal(got[1].numpy(), masks)


def test_forward_takes_host_arrays_and_device_tensors_alike(predictor):
    reqs = make_requests([(64, 64), (30, 50)], seed=3)
    arrays = pack_requests(reqs, predictor.bucket)[:3]
    a = predictor.forward(*arrays)
    b = predictor.forward(*(torch.from_numpy(x) for x in arrays))
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_predict_refuses_bad_requests(predictor):
    with pytest.raises(ValueError, match="at least one request"):
        predictor.predict([])
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="uint8 HWC RGB"):
        predictor.predict([(img, np.zeros((3, 4), np.float32))])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_pack_requests_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pack kernel has no CPU mode")
    bucket, sizes = CASES[case]
    reqs = make_requests(sizes, seed=len(sizes))
    images, masks, _, _ = pack_requests(reqs, bucket)
    staged, table = staged_on(reqs, bucket, "cuda")
    trace.reset_launches()
    got_images, got_masks = pack_kernel.pack_images(staged, table, bucket)
    torch.cuda.synchronize()
    assert trace.launch_counts()["pack"] == 1
    np.testing.assert_array_equal(got_images.cpu().numpy(), images)
    np.testing.assert_array_equal(got_masks.cpu().numpy(), masks)


@pytest.mark.cuda
def test_predictor_launches_one_pack_a_call_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pack kernel has no CPU mode")
    pred = Predictor(stage2_config(**TINY), device="cuda", bucket=(64, 64), seed=0)
    batches = [make_requests(CASES["odd"][1], seed=s) for s in range(3)]
    trace.reset_launches()
    for reqs in batches:
        used, shape, _ = pred._stage(reqs)
        got = pred._upload(used, shape)
        for g, w in zip(got, pack_requests(reqs, pred.bucket)[:3]):
            np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert trace.launch_counts()["pack"] == len(batches)

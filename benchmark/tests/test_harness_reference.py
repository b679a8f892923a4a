"""The plain reference against the program on the CPU at a tiny width: the
same weights (the benchmark's draw, loaded strictly by the program) give
the same outputs, both stages, with padding."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import model as reference, weights

TINY = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64)
W = {"cls_logit_std": 1.0, "cls_bias": -4.6}
EX = np.array([[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6], [0.2, 0.5, 0.4, 0.7]], np.float32)


def test_spec_is_the_program_state_dict():
    from countdetr_tpu_torch.config import stage1_config, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import CountingDetr

    for cfg in (stage2_config(), stage1_config()):
        sd = CountingDetr(cfg).state_dict()
        spec = {k: s for k, s, _ in weights.param_spec(dataclasses.asdict(cfg))}
        assert spec == {k: tuple(v.shape) for k, v in sd.items()}


def test_stage2_matches_the_program():
    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.serve import Predictor, pack_requests

    cfg = stage2_config(**TINY, num_query_position=64)
    m = dataclasses.asdict(cfg)
    p = weights.draw(m, W, 123, "cpu")
    pred = Predictor(cfg, state_dict=p, device="cpu", bucket=(96, 128))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), EX)
            for h, w in ((64, 96), (96, 128), (64, 64))]
    images, masks, rects, _ = pack_requests(reqs, (96, 128))
    out = pred.forward(images, masks, rects)
    ref = reference.run(p, m, [{"image": i, "exemplars": b, "bucket": (96, 128)} for i, b in reqs],
                        "cpu")
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        got = out[key].numpy()
        want = np.stack([r[key] for r in ref])
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_stage1_matches_the_program():
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.data.batching import pack_space_to_depth, pad_to_bucket
    from countdetr_tpu_torch.models.anchor_detr import build_model

    cfg = stage1_config(**TINY)
    m = dataclasses.asdict(cfg)
    p = weights.draw(m, W, 7, "cpu")
    model = build_model(cfg, device="cpu", state_dict=p)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    padded, mask = pad_to_bucket(img, (64, 128))
    pts = rng.uniform(0.01, 0.99, (10, 2)).astype(np.float32)
    tier = np.zeros((1, 16, 2), np.float32)
    tier[0, :10] = pts
    valid = np.zeros((1, 16), bool)
    valid[0, :10] = True
    with torch.no_grad():
        out = model(torch.from_numpy(pack_space_to_depth(padded[None])),
                    torch.from_numpy(mask[None]), torch.from_numpy(tier), torch.from_numpy(valid))
    ref = reference.run(p, m, [{"image": img, "points": pts, "bucket": (64, 128)}], "cpu")[0]
    for key in ("pred_logits", "pred_points", "pred_wh"):
        np.testing.assert_allclose(out[key][0, :10].numpy(), ref[key], atol=2e-5, rtol=0)


def test_compared_outputs_depend_on_the_image():
    from countdetr_tpu_torch.config import stage2_config

    m = dataclasses.asdict(stage2_config(**TINY, num_query_position=64))
    p = weights.draw(m, W, 5, "cpu")
    rng = np.random.default_rng(2)
    items = [{"image": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), "exemplars": EX,
              "bucket": (64, 64)} for _ in range(2)]
    a, b = reference.run(p, m, items, "cpu")
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        assert np.abs(a[key] - b[key]).max() > 1e-3


def test_reference_refuses_an_image_past_its_bucket():
    with pytest.raises(ValueError):
        reference.pad_into(np.zeros((100, 10, 3), np.uint8), (96, 96))

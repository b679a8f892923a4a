"""The yardstick's operation and byte counts against hand counts, and the
whole forward's count against the products the plain reference runs."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import model as reference, weights
from benchmark.yardstick import work

TINY = {"hidden_dim": 32, "nheads": 4, "enc_layers": 1, "dec_layers": 2, "dim_feedforward": 64,
        "num_query_position": 16, "num_query_pattern": 1, "num_classes": 2}
W = {"cls_logit_std": 1.0, "cls_bias": -4.6}


def test_rcda_hand_count():
    # L=2 queries, a 3 x 4 grid, E=8: scores 2*2*8*(3+4), combine 2*2*8*3*4
    assert work.rcda_work(2, 3, 4, 8, 4) == (2 * 2 * 8 * 7 + 2 * 2 * 8 * 12,
                                            4 * (3 * 2 * 8 + 7 * 8 + 12 * 8 + 7))
    # one count for every formulation, in bytes at the dtype's width
    assert work.rcda_work(2, 3, 4, 8, 2)[0] == work.rcda_work(2, 3, 4, 8, 4)[0]
    assert work.rcda_work(2, 3, 4, 8, 2)[1] * 2 == work.rcda_work(2, 3, 4, 8, 4)[1]


def test_mha_hand_count():
    assert work.mha_work(3, 5, 8, 4) == (4 * 3 * 5 * 8, 4 * (2 * 3 * 8 + 2 * 5 * 8) + 4 * 5)


def test_peaks_and_bound():
    assert work.PEAK_FLOPS["float32"] == 495e12  # TF32 dense: no float32 product is faster
    assert work.PEAK_FLOPS["bfloat16"] == 989e12 and work.HBM_BYTES_PER_S == 3.35e12
    # operations or bytes, whichever is slower; nothing else (no exponential bound)
    assert work.bound_seconds(495e12, 1.0, "float32") == pytest.approx(1.0)
    assert work.bound_seconds(1.0, 3.35e12, "float32") == pytest.approx(1.0)


def test_queries_and_calls():
    m = {**TINY, "spatial_prior": "grid", "num_query_position": 600, "enc_layers": 6,
         "dec_layers": 6}
    assert work.num_queries(m) == 576
    assert work.num_queries({**m, "spatial_prior": "defined"}, 3731) == 3731
    calls = work.rcda_calls(m, 24, 37, 576)
    assert calls[:6] == [(888, 24, 37)] * 6 and calls[6:] == [(576, 24, 37)] * 6
    assert work.mha_calls(m, 576) == [(576, 576)] * 6


def _count_products(monkeypatch):
    """Patch the reference's products to add up their FLOPs: (counter,
    list of the einsum calls' (letters, sizes))."""
    total = {"flops": 0.0}
    conv, linear, einsum = F.conv2d, F.linear, torch.einsum

    def conv2d(x, w, *a, **k):
        out = conv(x, w, *a, **k)
        total["flops"] += 2.0 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    def lin(x, w, b=None):
        total["flops"] += 2.0 * x.numel() / x.shape[-1] * w.shape[0] * w.shape[1]
        return linear(x, w, b)

    def ein(eq, *ops):
        ins = eq.split("->")[0].split(",")
        sizes = {}
        for letters, op in zip(ins, ops):
            sizes.update(zip(letters, op.shape))
        total["flops"] += 2.0 * math.prod(sizes.values())
        return einsum(eq, *ops)

    monkeypatch.setattr(F, "conv2d", conv2d)
    monkeypatch.setattr(F, "linear", lin)
    monkeypatch.setattr(torch, "einsum", ein)
    return total


@pytest.mark.parametrize("stage", [1, 2])
def test_forward_flops_match_the_reference(stage, monkeypatch):
    m = dict(TINY, stage=stage, spatial_prior="grid" if stage == 2 else "defined",
             with_variance_head=stage == 2)
    h, w, n = 64, 96, 7
    p = weights.draw(m, W, 3, "cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8))
    pad = torch.zeros(1, h, w, dtype=torch.bool)
    total = _count_products(monkeypatch)
    with torch.no_grad():
        if stage == 2:
            reference.forward(p, m, images, pad, exemplars=torch.rand(1, 3, 4))
        else:
            pts = torch.rand(1, n, 2)
            reference.forward(p, m, images, pad, points=pts,
                              points_valid=torch.ones(1, n, dtype=torch.bool))
    q = work.num_queries(m, n)
    _, h5, w5 = work.backbone_macs(h, w)
    assert (h5, w5) == (h // 16, w // 16)
    # the reference's two-stage combine runs 2 L E H more than any
    # formulation needs (the count is the same for every formulation)
    second_stage = sum(2 * L * m["hidden_dim"] * H for L, H, _ in work.rcda_calls(m, h5, w5, q))
    assert total["flops"] == pytest.approx(work.forward_flops(m, h, w, n) + second_stage, rel=1e-12)


def test_backbone_count_at_592():
    macs, h5, w5 = work.backbone_macs(592, 592)
    assert (h5, w5) == (37, 37)
    # ResNet-50 is 4.1 GMAC at 224 x 224; DC5 runs layer4 at stride 16
    assert 40e9 < macs < 50e9


def test_core_bounds_at_real_sizes():
    m = {**TINY, "hidden_dim": 256, "enc_layers": 6, "dec_layers": 6, "spatial_prior": "grid",
         "num_query_position": 600}
    small = work.core_bounds(m, [(384, 384, 0)], "float32")
    large = work.core_bounds(m, [(592, 592, 0)], "float32")
    assert 0 < small[0] < large[0] and small[1] == large[1] > 0  # MHA: the queries only

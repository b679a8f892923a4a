"""Leaf ops of the PyTorch port against the JAX package, on the CPU.

Same numpy inputs on both sides; float32; atol 1e-6 for arithmetic (the
same float32 operations in the same order, up to libm differences in
sin/cos/exp/log), exact equality for masks, indices and packed bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.data import batching as jbatch
from countdetr_tpu.eval.postprocess import topk_postprocess as j_topk
from countdetr_tpu.models import anchor_detr as jdetr
from countdetr_tpu.models.resnet import downsample_mask as j_downsample_mask
from countdetr_tpu.ops import boxes as jboxes
from countdetr_tpu.ops import posemb as jpos

from countdetr_tpu_torch.data import batching as tbatch
from countdetr_tpu_torch.eval.postprocess import topk_postprocess as t_topk
from countdetr_tpu_torch.models import anchor_detr as tdetr
from countdetr_tpu_torch.models.resnet import downsample_mask as t_downsample_mask
from countdetr_tpu_torch.ops import boxes as tboxes
from countdetr_tpu_torch.ops import posemb as tpos

ATOL = 1e-6


def close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("feats", [32, 256])
def test_pos2posemb1d(rng, feats):
    pos = rng.uniform(0, 1, (3, 7)).astype(np.float32)
    close(tpos.pos2posemb1d(torch.from_numpy(pos), feats),
          jpos.pos2posemb1d(jnp.asarray(pos), feats), atol=2e-6)


def test_pos2posemb2d_is_y_then_x(rng):
    pos = rng.uniform(0, 1, (2, 5, 2)).astype(np.float32)
    got = tpos.pos2posemb2d(torch.from_numpy(pos), 16)
    close(got, jpos.pos2posemb2d(jnp.asarray(pos), 16), atol=2e-6)
    close(got[..., :16], tpos.pos2posemb1d(torch.from_numpy(pos[..., 1]), 16), atol=0)


def test_mask2pos_with_padding():
    mask = np.zeros((2, 6, 9), dtype=bool)
    mask[1, 4:, :] = True
    mask[1, :, 5:] = True
    got_c, got_r = tpos.mask2pos(torch.from_numpy(mask))
    want_c, want_r = jpos.mask2pos(jnp.asarray(mask))
    close(got_c, want_c)
    close(got_r, want_r)


@pytest.mark.parametrize("n", [25, 600])
def test_grid_reference_points(n):
    got = tpos.grid_reference_points(n)
    want = jpos.grid_reference_points(n)
    assert tuple(got.shape) == want.shape
    close(got, want, atol=0)


def test_inverse_sigmoid_and_cxcywh_to_xyxy(rng):
    x = np.concatenate([rng.uniform(-0.1, 1.1, 50), [0.0, 1.0, 1e-7, 1 - 1e-7]]).astype(np.float32)
    close(tboxes.inverse_sigmoid(torch.from_numpy(x)), jboxes.inverse_sigmoid(jnp.asarray(x)), atol=2e-6)
    b = rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)
    close(tboxes.box_cxcywh_to_xyxy(torch.from_numpy(b)), jboxes.box_cxcywh_to_xyxy(jnp.asarray(b)))


@pytest.mark.parametrize("shape", [(50, 70), (40, 64), (130, 60), (97, 200)])
def test_pad_to_bucket_matches(rng, shape):
    """Padding, the pad mask, and the bilinear downscale of an oversize image."""
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    got, gmask = tbatch.pad_to_bucket(img, (96, 128))
    want, wmask = jbatch.pad_to_bucket(img, (96, 128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)


def test_pack_space_to_depth_matches(rng):
    imgs = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    got = tbatch.pack_space_to_depth(imgs)
    np.testing.assert_array_equal(got, jbatch.pack_space_to_depth(imgs))
    assert got.shape == (2, 4, 6, 12)
    with pytest.raises(ValueError):
        tbatch.pack_space_to_depth(imgs[:, :7])


@pytest.mark.parametrize("H,W,h,w", [(64, 64, 4, 4), (592, 592, 37, 37),
                                      (100, 75, 7, 5), (75, 100, 19, 13), (296, 296, 74, 74)])
def test_downsample_mask_exact(H, W, h, w):
    """Nearest-neighbour indices in float32, exact also where H/h is not an
    integer."""
    rng = np.random.default_rng(H * W + h)
    mask = rng.uniform(size=(2, H, W)) < 0.3
    got = t_downsample_mask(torch.from_numpy(mask), h, w).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_downsample_mask(jnp.asarray(mask), h, w)))


def test_pack_mask_s2d_and_normalize_uint8(rng):
    mask = rng.uniform(size=(2, 10, 14)) < 0.5
    np.testing.assert_array_equal(
        tdetr.pack_mask_s2d(torch.from_numpy(mask)).numpy(),
        np.asarray(jdetr.pack_mask_s2d(jnp.asarray(mask))))
    for C in (3, 12):
        img = rng.integers(0, 256, (2, 5, 7, C), dtype=np.uint8)
        close(tdetr.normalize_uint8(torch.from_numpy(img)), jdetr.normalize_uint8(jnp.asarray(img)))


def test_exemplar_aggregate(rng):
    """Centre-pixel sampling with int() truncation and clipping: boxes on
    pixel boundaries and partly outside the map included."""
    B, h, w, C, K = 2, 5, 7, 8, 3
    feat = rng.normal(size=(B, h, w, C)).astype(np.float32)
    rects = rng.uniform(0, 1, (B, K, 4)).astype(np.float32)
    rects[0, 0] = [0.0, 0.0, 2 / 7, 0.4]  # centre exactly on a pixel edge
    rects[1, 2] = [0.9, 0.95, 1.3, 1.2]  # centre outside: clipped
    got = tdetr.exemplar_aggregate(torch.from_numpy(feat), torch.from_numpy(rects))
    close(got, jdetr.exemplar_aggregate(jnp.asarray(feat), jnp.asarray(rects)))


@pytest.mark.parametrize("padded", [False, True])
def test_masked_group_norm(rng, padded):
    B, H, W, C = 2, 5, 6, 64
    x = rng.normal(1.0, 2.0, (B, H, W, C)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, C).astype(np.float32)
    bias = rng.normal(0.0, 0.1, C).astype(np.float32)
    valid = None
    if padded:
        valid = np.ones((B, H, W), dtype=bool)
        valid[1, 3:, :] = False
        valid[1, :, 4:] = False
    jv = None if valid is None else jnp.asarray(valid)
    want = jdetr.MaskedGroupNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), jv)
    gn = tdetr.MaskedGroupNorm(C)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x), None if valid is None else torch.from_numpy(valid))
    close(got, want, atol=2e-6)


def test_topk_postprocess(rng):
    logits = rng.normal(size=(2, 30, 2)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (2, 30, 4)).astype(np.float32)
    sizes = np.array([[480, 640], [300, 200]], dtype=np.float32)
    got = t_topk(torch.from_numpy(logits), torch.from_numpy(boxes), torch.from_numpy(sizes), k=10)
    want = j_topk(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes), k=10)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    close(got["scores"], want["scores"])
    close(got["boxes"], want["boxes"], atol=1e-4)

"""The port's mask head pieces (countdetr_tpu_torch/models/segmentation.py)
against the JAX package's (countdetr_tpu/models/segmentation.py), on the
CPU, float32, on seeded numpy inputs:

- ``MHAttentionMap`` with a padded image, and ``MaskHeadSmallConv`` over
  skips whose sizes are not doublings of the trunk's (5x7 -> 9x13 -> 18x26:
  the resize is JAX's "nearest", torch's "nearest-exact"), with the JAX
  module's params mapped as ``params_from_jax`` maps them; atol/rtol 1e-4;
- the nearest resize itself at 7 -> 13 (where torch's "nearest" picks other
  pixels), 5 -> 9 and 13 -> 7, exactly;
- ``dice_loss`` and ``mask_losses`` with invalid rows, rtol 1e-5;
- ``postprocess_masks`` up (18x26 -> 72x104), down (18x26 -> 11x17, JAX
  antialiases when it shrinks) and to a size of another aspect: the same
  masks, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from countdetr_tpu.models import segmentation as jseg

from countdetr_tpu_torch.models import segmentation as tseg
from test_torch_longtail import fill_params

TOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x))


def load(module, params, transpose_dense=False):
    """A flax params dict onto a torch module by name: conv kernels HWIO ->
    OIHW, Dense kernels (in, out) -> (out, in), norm scales -> weight."""
    sd = {}
    for name, m in params.items():
        for leaf, v in m.items():
            v = np.asarray(v)
            if leaf == "kernel":
                v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
            sd[f"{name}.{'weight' if leaf in ('kernel', 'scale') else leaf}"] = t(v.copy())
    module.load_state_dict(sd, strict=True)
    return module


def test_mh_attention_map_matches_jax():
    rng = np.random.default_rng(0)
    B, Q, C, n, h, w = 2, 7, 32, 4, 5, 6
    q = rng.normal(size=(B, Q, C)).astype(np.float32)
    f = rng.normal(size=(B, h, w, C)).astype(np.float32)
    mask = np.zeros((B, h, w), bool)
    mask[1, 3:] = True
    mask[1, :, 4:] = True
    jm = jseg.MHAttentionMap(C, n)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), q, f, mask), 1)
    want = np.asarray(jm.apply(params, q, f, mask))
    port = load(tseg.MHAttentionMap(C, C, n), params["params"])
    with torch.no_grad():
        got = port(t(q), t(f), t(mask)).numpy()
    assert got.shape == want.shape == (B, Q, n, h, w)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.abs(got[1][..., 3:, :]).max() < 1e-30  # padded pixels weigh nothing


def test_mask_head_small_conv_matches_jax():
    rng = np.random.default_rng(1)
    B, Q, C, n = 2, 3, 32, 4
    x = rng.normal(size=(B * Q, 5, 7, C + n)).astype(np.float32)
    skips = [rng.normal(size=(B, hh, ww, c)).astype(np.float32)
             for (hh, ww), c in (((5, 7), 1024), ((9, 13), 512), ((18, 26), 256))]
    jm = jseg.MaskHeadSmallConv(C)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, skips), 2)
    want = np.asarray(jax.jit(jm.apply)(params, x, skips))
    port = load(tseg.MaskHeadSmallConv(C + n, (1024, 512, 256), C), params["params"])
    assert port.gn1.num_groups == 6 and port.gn1.eps == 1e-6  # max d <= 8 with 36 % d == 0
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2), [t(s).permute(0, 3, 1, 2) for s in skips]).numpy()
    assert got.shape == want.shape == (B * Q, 18, 26)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("src,dst", [((7, 7), (13, 13)), ((5, 9), (9, 17)), ((13, 13), (7, 7))])
def test_nearest_resize_is_jax_nearest(src, dst):
    x = np.arange(np.prod(src), dtype=np.float32).reshape(1, 1, *src)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, *dst), "nearest"))
    got = F.interpolate(t(x), size=dst, mode="nearest-exact").numpy()
    np.testing.assert_array_equal(got, want)
    if src == (7, 7):  # torch's floor-based "nearest" is not it
        assert not np.array_equal(F.interpolate(t(x), size=dst, mode="nearest").numpy(), want)


def test_dice_and_mask_losses_match_jax():
    rng = np.random.default_rng(3)
    N, H, W = 6, 9, 13
    logits = rng.normal(0, 3, (N, H, W)).astype(np.float32)
    tgt = rng.uniform(size=(N, H, W)) > 0.6
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    num_boxes = 4.0
    want = jseg.mask_losses(jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(valid), num_boxes)
    got = tseg.mask_losses(t(logits), t(tgt), t(valid), num_boxes)
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    flat = logits.reshape(N, -1), tgt.reshape(N, -1).astype(np.float32)
    np.testing.assert_allclose(tseg.dice_loss(*map(t, flat), num_boxes).item(),
                               float(jseg.dice_loss(*map(jnp.asarray, flat), num_boxes)),
                               rtol=1e-5)


@pytest.mark.parametrize("target", [(72, 104), (11, 17), (40, 90)], ids=["up", "down", "aspect"])
def test_postprocess_masks_matches_jax(target):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (5, 18, 26)).astype(np.float32)
    want = np.asarray(jseg.postprocess_masks(jnp.asarray(logits), target))
    got = tseg.postprocess_masks(t(logits), target).numpy()
    assert got.dtype == bool and got.shape == want.shape == (5, *target)
    np.testing.assert_array_equal(got, want)
    assert tseg.postprocess_masks(t(logits[:0]), target).shape == (0, *target)

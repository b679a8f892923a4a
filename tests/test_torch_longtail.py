"""AnchorDETR's remaining model options in the port against the JAX
package, on the CPU: standard attention (``attention_type="MHA"``), three
feature levels (stage 1) and the mask head (``masks``).

The JAX params of each configuration come from ``jax.eval_shape`` of its
init, filled from a numpy seed (``fill_params``: fan-in scaled weights,
unit-ish norms, positive running variances), and go to the port through
``params_from_jax``. Both sides take the same packed uint8 batch with one
padded image; the JAX side runs its plain (einsum) attention cores, as on
any CPU. Forwards agree within 1e-4 (atol and rtol, the tolerance of
tests/test_torch_model.py), ``pred_masks`` included, at 72x104 for the
mask head: not a multiple of 32, so the trunk's resizes to the C3 skip are
not exact doublings (C4 5x7 -> C3 9x13).

Three levels with standard attention is a combination the JAX transformer
cannot build (its 2-D position embedding is made for B images, not for
the l*B level rows); the port refuses it with ValueError.

Weights: ``params_from_jax`` uses every leaf once and loads strictly, and
the JAX importer maps the port's state dict back to the same params; a
reference-layout .pth (``input_proj.{0,1,2}``, the level layers, the
unused ``adapt_pos1d`` of a standard-attention model, DETRsegm's
``detr.``-prefixed file with its ``bbox_attention`` and ``mask_head``) is
read by both importers to models whose forwards agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train import checkpoints as jckpt

from countdetr_tpu_torch.config import stage1_config, stage2_config
from countdetr_tpu_torch.models.anchor_detr import CountingDetr, build_model
from countdetr_tpu_torch.models.transformer import LevelEncoderLayer
from countdetr_tpu_torch.ops.kernels import mha_kernel
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_checkpoints import reference_pth
from test_torch_model import make_batch, reference_state_dict

TINY = dict(enc_layers=2, dec_layers=2, hidden_dim=32, nheads=4, dim_feedforward=64)
TOL = 1e-4
# name: (stage, model options, (H, W) of the batch)
CASES = {
    "mha-stage1": (1, dict(attention_type="MHA"), (64, 96)),
    "mha-stage2": (2, dict(attention_type="MHA"), (64, 96)),
    "levels-v3": (1, dict(num_feature_levels=3), (64, 96)),
    "levels-rank1": (1, dict(num_feature_levels=3, rcda_variant="rank1"), (64, 96)),
    "masks-stage1": (1, dict(masks=True), (72, 104)),
    "masks-stage2": (2, dict(masks=True), (72, 104)),
}
P = 12  # stage-1 points a image


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread spares the port's side the thread
    pool's cost while the suite's other workers hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name):
    stage, kw, _ = CASES[name]
    kw = dict(TINY, **kw)
    port_kw = dict(kw)
    kw.pop("rcda_variant", None)  # the JAX package's CPU path has one RCDA core
    if stage == 1:
        return jcfg.stage1_config().model.replace(**kw), stage1_config(**port_kw)
    kw.update(num_query_position=25)
    port_kw.update(num_query_position=25)
    return jcfg.stage2_config().model.replace(**kw), stage2_config(**port_kw)


def fill_params(shapes, seed):
    """Values for an eval_shape'd flax tree, from a numpy seed: conv and
    Dense kernels normal / sqrt(fan-in), (out, in) weights uniform within
    1 / sqrt(in), norm scales and frozen-BN weights near 1, running
    variances in [0.5, 1.5], biases and means small, the query pattern and
    level embedding standard normal, learned anchors in the unit square."""
    rng = np.random.default_rng(seed)

    def f(path, s):
        leaf, shape = path[-1].key, s.shape
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean":
            v = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "kernel":
            v = rng.normal(0.0, 1.0, shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale" or (leaf == "weight" and len(shape) == 1):
            v = 1.0 + rng.normal(0.0, 0.05, shape)
        elif leaf in ("pattern", "level_embed"):
            v = rng.normal(0.0, 1.0, shape)
        elif leaf == "position":
            v = rng.uniform(0.05, 0.95, shape)
        elif len(shape) == 2:
            v = rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[1])
        else:
            v = rng.normal(0.0, 0.05, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(f, shapes)


def make_inputs(name, seed):
    stage, _, (H, W) = CASES[name]
    packed, mask, rects = make_batch(seed, H=H, W=W, pad=(H - 16, W - 24))
    rng = np.random.default_rng(100 + seed)
    points = rng.uniform(0.05, 0.6, (2, P, 2)).astype(np.float32)
    valid = np.ones((2, P), bool)
    valid[1, P - 4:] = False
    return dict(images=packed, pad_mask=mask, exemplar_boxes=rects, points=points,
                points_valid=valid)


def jax_args(stage, x):
    kw = dict(points=jnp.asarray(x["points"]), points_valid=jnp.asarray(x["points_valid"])) \
        if stage == 1 else dict(exemplar_boxes=jnp.asarray(x["exemplar_boxes"]))
    return (jnp.asarray(x["images"]), jnp.asarray(x["pad_mask"])), kw


def port_args(stage, x):
    names = ("images", "pad_mask") + (("points", "points_valid") if stage == 1
                                      else ("exemplar_boxes",))
    return [torch.from_numpy(x[k]) for k in names]


@functools.lru_cache(maxsize=None)
def jax_model_params(name):
    """(the JAX model, its params); the RCDA variants share the JAX side."""
    if name == "levels-rank1":
        return jax_model_params("levels-v3")
    stage = CASES[name][0]
    model = JaxCountingDetr(configs(name)[0])
    args, kw = jax_args(stage, make_inputs(name, 0))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args, **kw)
    return model, fill_params(shapes, sorted(CASES).index(name))


@functools.lru_cache(maxsize=None)
def jax_apply(name):
    """The JAX model's apply, jitted once a configuration."""
    return jax.jit(jax_model_params(name)[0].apply)


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """(the JAX model, its params, its forward on one batch)."""
    model, params = jax_model_params(name)
    args, kw = jax_args(CASES[name][0], make_inputs(name, 1))
    want = jax_apply(name)(params, *args, **kw)
    return model, params, jax.tree_util.tree_map(np.asarray, want)


def port_model(name, params):
    return build_model(configs(name)[1], device="cpu", state_dict=params_from_jax(params))


def assert_outputs_close(got, want):
    assert set(got) == set(want)
    for key in want:
        g = got[key].numpy()
        assert g.shape == want[key].shape and g.dtype == np.float32, key
        np.testing.assert_allclose(g, want[key], atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    """Every output, pred_masks (B, L, H/4, W/4) included."""
    stage = CASES[name][0]
    _, params, want = jax_reference(name)
    with torch.inference_mode():
        got = port_model(name, params)(*port_args(stage, make_inputs(name, 1)))
    assert_outputs_close(got, want)
    if "masks" in name:
        H, W = CASES[name][2]
        assert got["pred_masks"].shape[2:] == (H // 4, W // 4)


@pytest.mark.parametrize("name", ["masks-stage2", "levels-v3"])
def test_forward_without_the_mask_head_is_the_same(name):
    """``masks=False`` (the engine's and the losses' call) leaves the other
    outputs bit-equal and drops pred_masks."""
    stage = CASES[name][0]
    _, params, _ = jax_reference(name)
    model = port_model(name, params)
    x = port_args(stage, make_inputs(name, 2))
    with torch.inference_mode():
        full, bare = model(*x), model(*x, masks=False)
    assert set(full) - set(bare) == ({"pred_masks"} if "masks" in name else set())
    for key in bare:
        torch.testing.assert_close(bare[key], full[key], atol=0, rtol=0)


def test_levels_with_standard_attention_fails_in_both():
    jc, _ = configs("levels-v3")
    jmodel = JaxCountingDetr(jc.replace(attention_type="MHA"))
    args, kw = jax_args(1, make_inputs("levels-v3", 0))
    with pytest.raises(ValueError, match="broadcast"):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args, **kw)
    with pytest.raises(ValueError, match="RCDA attention only"):
        CountingDetr(configs("levels-v3")[1].replace(attention_type="MHA"))


@pytest.mark.parametrize("bad,match", [
    (dict(num_feature_levels=2), "1 or 3"),
    (dict(num_feature_levels=3, masks=True), "masks exclude"),
    (dict(num_feature_levels=3, dilation=False), "DC5"),
], ids=["two-levels", "levels-masks", "levels-no-dc5"])
def test_combinations_jax_cannot_build_raise(bad, match):
    """Each fails in the JAX model (its asserts, or shapes that do not meet)
    and raises ValueError in the port; levels in stage 2 too."""
    jc, pc = configs("levels-v3")
    jmodel = JaxCountingDetr(jc.replace(**bad))
    args, kw = jax_args(1, make_inputs("levels-v3", 0))
    with pytest.raises((AssertionError, ValueError, TypeError)):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args, **kw)
    with pytest.raises(ValueError, match=match):
        CountingDetr(pc.replace(**bad))
    with pytest.raises(ValueError, match="exemplar aggregation"):
        CountingDetr(stage2_config(**TINY, num_feature_levels=3))


@pytest.mark.parametrize("name", ["mha-stage2", "levels-v3", "masks-stage2"])
def test_params_from_jax_round_trip(name):
    """Every leaf becomes one port tensor under the reference's name (the
    level layers, level_fc, level_embed, the three input projections, the
    mask head), the strict load needs no other, and the JAX importer maps
    the port's state dict back to the same params."""
    _, params, _ = jax_reference(name)
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    model = CountingDetr(configs(name)[1])
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    if name == "levels-v3":
        assert {"input_proj.2.0.weight", "transformer.level_embed.weight",
                "transformer.encoder_layers_level.0.self_attn_level.in_proj_weight",
                "transformer.decoder_layers.1.level_fc.weight"} <= set(sd)
        assert sd["input_proj.0.0.weight"].shape == (32, 512, 3, 3)
    if name == "masks-stage2":
        np.testing.assert_array_equal(
            sd["bbox_attention.q_linear.weight"].numpy(),
            np.asarray(params["params"]["bbox_attention"]["q_linear"]["kernel"]).T)
    if name == "mha-stage2":
        assert not any("adapt_pos1d" in k for k in sd)
    back = jckpt.torch_state_dict_to_params(reference_state_dict(model), params, strict=True)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_allclose(np.asarray(flat_back[path]), np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_level_fc_reads_the_level_fastest_flattening():
    """level_fc's input column c*l + level: a weight that reads only level
    2 of channel 0 gives the decoder's cross-attention output of that level."""
    from countdetr_tpu_torch.models.transformer import DecoderLayer

    torch.manual_seed(0)
    layer = DecoderLayer(8, 16, 2, num_levels=3)
    B, L, l = 2, 5, 3
    x = torch.randn(l * B, L, 8)  # the level-major cross-attention output
    with torch.no_grad():
        layer.level_fc.weight.zero_()
        layer.level_fc.bias.zero_()
        layer.level_fc.weight[0, 0 * l + 2] = 1.0
    merged = layer.level_fc(x.reshape(l, B, L, 8).permute(1, 2, 3, 0).reshape(B, L, 8 * l))
    torch.testing.assert_close(merged[..., 0], x.reshape(l, B, L, 8)[2, ..., 0])


@pytest.mark.parametrize("name", ["mha-stage2", "levels-v3", "masks-stage2"])
def test_reference_pth_reads_to_equal_forwards(tmp_path, name):
    """A reference-layout .pth through both importers: the port's strict
    load_torch_checkpoint and the JAX torch_state_dict_to_params, then
    both forwards on one batch."""
    stage = CASES[name][0]
    _, params = jax_model_params(name)
    src = port_model(name, params)
    if stage == 1:
        with torch.no_grad():  # the reference's (1,) class bias
            src.transformer.cls_embed[0].bias.fill_(-4.5)
    path = str(tmp_path / "ref.pth")
    sd = reference_pth(src, path, stage)
    if name == "masks-stage2":
        assert "detr.transformer.pattern.weight" in sd and "mask_head.lay1.weight" in sd
    if name == "mha-stage2":
        assert "transformer.adapt_pos1d.0.weight" in sd  # kept by the reference, unused
    dst = build_model(src.cfg, device="cpu", seed=1)
    dst.load_state_dict(ckpt.load_torch_checkpoint(path, dst), strict=True)
    jparams = jckpt.torch_state_dict_to_params(jckpt.load_torch_checkpoint(path), params,
                                               strict=True)
    x = make_inputs(name, 3)
    args, kw = jax_args(stage, x)
    want = jax.tree_util.tree_map(np.asarray, jax_apply(name)(jparams, *args, **kw))
    with torch.inference_mode():
        got = dst(*port_args(stage, x))
    assert_outputs_close(got, want)


def test_level_layer_beyond_65535_pixels_on_the_plain_core():
    """The level layer's batch is B*H*W pixels: 2 x 200 x 180 = 72000 rows
    of 3 keys, past CUDA's 65535 limit on gridDim.z (the kernel takes the
    batch on gridDim.x). On the CPU the core is the plain version: the
    shape comes through, and a pixel's output equals that pixel alone."""
    torch.manual_seed(0)
    layer = LevelEncoderLayer(32, 64, 4).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    src = torch.randn(2, 3, 200, 180, 32)
    emb = torch.randn(3, 32)
    with torch.inference_mode():
        out = layer(src, emb)
        one = layer(src[1:2, :, 17:18, 101:102], emb)
    assert out.shape == src.shape and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[1:2, :, 17:18, 101:102], one, atol=1e-6, rtol=1e-6)
    q = torch.randn(72000, 3, 32)
    assert mha_kernel.mha_core(q, q, q, torch.zeros(72000, 3), 4).shape == (72000, 3, 32)

"""The PyTorch port's stage-2 model against the JAX package, on the CPU.

Both sides get the same numpy inputs and the same weights: random JAX
params mapped into the port by ``countdetr_tpu_torch.weights.params_from_jax``.
Both run in float32, the JAX side at 'highest' matmul precision
(tests/conftest.py). Tolerance 1e-4 (atol and rtol) on the heads: the two
frameworks run ResNet-50 and six attention blocks with different conv and
matmul algorithms, so float32 sums differ in order through ~60 layers;
1e-4 is far below any change of a count or a box that matters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.data.batching import pack_space_to_depth as jax_pack
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.models.resnet import ResNetBackbone as JaxBackbone
from countdetr_tpu.train.checkpoints import torch_state_dict_to_params

from countdetr_tpu_torch.config import stage2_config
from countdetr_tpu_torch.models.anchor_detr import CountingDetr, build_model
from countdetr_tpu_torch.models.resnet import ResNetBackbone
from countdetr_tpu_torch.models.transformer import WH_BIAS
from countdetr_tpu_torch.weights import params_from_jax

TINY = dict(enc_layers=2, dec_layers=2, hidden_dim=32, nheads=4,
            dim_feedforward=64, num_query_position=25)
TOL = 1e-4
BBOX_LAST_BIAS = "transformer.bbox_embed.0.layers.2.bias"


def tiny_configs():
    return jcfg.stage2_config().model.replace(**TINY), stage2_config(**TINY)


def perturb(variables, seed):
    """Every leaf of an init'ed flax tree moved by seeded noise, so zero- and
    constant-initialised parameters (biases, the bbox head, frozen BN) are
    exercised too; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x, np.float32)
        if "running_var" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "running_mean" in name:
            return rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        return (x + rng.normal(0.0, 0.02, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def make_batch(seed, B=2, H=64, W=64, K=3, pad=(48, 40)):
    """Raw uint8 images, s2d-packed, with image 1 padded to its top-left
    pad[0] x pad[1] region; exemplar boxes inside the content."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8)
    mask = np.zeros((B, H, W), dtype=bool)
    mask[1, pad[0]:, :] = True
    mask[1, :, pad[1]:] = True
    raw[mask] = 0
    rects = rng.uniform(0.05, 0.6, (B, K, 4)).astype(np.float32)
    rects[..., 2:] = rects[..., :2] + rng.uniform(0.05, 0.3, (B, K, 2))
    return jax_pack(raw), mask, rects


def jax_model_and_params(seed=0, cfg=None):
    cfg = cfg or tiny_configs()[0]
    model = JaxCountingDetr(cfg)
    packed, mask, rects = make_batch(seed)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(packed),
                                    jnp.asarray(mask), exemplar_boxes=jnp.asarray(rects))
    return model, perturb(variables, seed)


def reference_state_dict(model):
    """The port's state_dict as numpy, in the reference .pth form that the
    JAX package's importer reads: the wh bias folded into the bbox head's
    last bias (the port, like the JAX package, adds it in the forward)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sd[BBOX_LAST_BIAS] = sd[BBOX_LAST_BIAS] + np.asarray(WH_BIAS, np.float32)
    return sd


def port_model(params, cfg=None):
    cfg = cfg or tiny_configs()[1]
    return build_model(cfg, device="cpu", state_dict=params_from_jax(params))


@pytest.fixture(scope="module")
def stage2_pair():
    model, params = jax_model_and_params(seed=0)
    return model, params, port_model(params)


def test_backbone_packed_input_with_padding(stage2_pair):
    """ResNet-50-DC5 on the 12-channel packed input, one image padded: C5
    features agree with the JAX backbone, padding re-zeroing included."""
    _, params, port = stage2_pair
    packed, mask, _ = make_batch(1)
    x = ((packed.astype(np.float32) / 255.0) - 0.45) / 0.225
    x[np.repeat(mask.reshape(2, 32, 2, 32, 2).transpose(0, 1, 3, 2, 4).reshape(2, 32, 32, 4), 3, -1)] = 0.0
    want = np.asarray(JaxBackbone().apply(
        {"params": params["params"]["backbone"]}, jnp.asarray(x), jnp.asarray(mask))[0])
    body = port.backbone["body"]
    assert isinstance(body, ResNetBackbone)
    with torch.inference_mode():
        got = body(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 2048)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_stage2_forward_matches_jax(stage2_pair):
    """The whole stage-2 forward on a packed uint8 batch with one padded
    image: logits, boxes, variances and reference points."""
    jmodel, params, port = stage2_pair
    packed, mask, rects = make_batch(2)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(packed), jnp.asarray(mask),
                                 exemplar_boxes=jnp.asarray(rects))
    with torch.inference_mode():
        got = port(torch.from_numpy(packed), torch.from_numpy(mask), torch.from_numpy(rects))
    for key in ("pred_logits", "pred_boxes", "pred_vars", "reference_points"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == np.float32, key
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=key)


def test_params_from_jax_fills_every_parameter(stage2_pair):
    """Every JAX leaf becomes exactly one port tensor, and the port's strict
    load needs no other: nothing missing, nothing left over."""
    _, params, port = stage2_pair
    sd = params_from_jax(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    assert set(sd) == set(port.state_dict())
    fresh = CountingDetr(tiny_configs()[1])
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not missing and not unexpected


def test_state_dict_round_trip_through_jax_importer(stage2_pair):
    """The port's state_dict carries the reference torch keys: with the wh
    bias folded in as a reference .pth holds it, the JAX package's own
    importer maps it back to the params it came from (the wh bias goes in
    and out again, hence atol 1e-6 rather than exact)."""
    _, params, port = stage2_pair
    sd = reference_state_dict(port)
    back = torch_state_dict_to_params(sd, params, strict=True)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_allclose(np.asarray(flat_back[path]), np.asarray(want),
                                   atol=1e-6, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_stem_weight_keeps_reference_layout(stage2_pair):
    _, _, port = stage2_pair
    assert tuple(port.state_dict()["backbone.body.conv1.weight"].shape) == (64, 3, 7, 7)


def test_seeded_init_is_reproducible_and_finite():
    cfg = tiny_configs()[1]
    a = build_model(cfg, device="cpu", seed=3).state_dict()
    b = build_model(cfg, device="cpu", seed=3).state_dict()
    c = build_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    packed, mask, rects = make_batch(5)
    model = build_model(cfg, device="cpu", seed=3)
    with torch.inference_mode():
        out = model(torch.from_numpy(packed), torch.from_numpy(mask), torch.from_numpy(rects))
    assert all(torch.isfinite(v).all() for v in out.values())
    # bbox head zero-init + wh bias -2: wh == sigmoid(-2) at init
    np.testing.assert_allclose(out["pred_boxes"][..., 2:].numpy(),
                               1 / (1 + np.exp(2.0)), atol=1e-6)

"""The port's stage 1 (the point->wh pseudo-GT regressor) against the JAX
package, on the CPU.

(a) The forward of a tiny stage-1 model (2+2 layers, hidden 64, one padded
    128x128 image, 40 points with some invalid) on the same weights, under
    both RCDA variants: float32, so the rank-1 core differs from the JAX
    package's einsum core (what its CPU path runs) only in the order of its
    sums; atol/rtol 1e-4 as in tests/test_torch_model.py.
(b) stage1_criterion against the JAX criterion, one all-invalid row.
(c) One Trainer step against the JAX package's make_train_step for stage 1:
    the losses, and every parameter after the update at atol 2e-6. The step
    runs SGD (the reference's --sgd), whose update is linear in the
    gradient: Adam's first step moves each weight by about lr * sign(g), so
    a gradient within float32 noise of zero may flip it by 2 * lr on one
    side only, which says nothing of the stage-1 path (the AdamW update
    rule itself is held at 2e-6 in tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.ops import losses as jlosses
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from countdetr_tpu.train.train_step import create_state, make_train_step

from countdetr_tpu_torch.config import TrainConfig, stage1_config
from countdetr_tpu_torch.data.batching import pack_space_to_depth
from countdetr_tpu_torch.models.anchor_detr import CountingDetr, build_model
from countdetr_tpu_torch.ops import losses as tlosses
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import perturb

TINY1 = dict(enc_layers=2, dec_layers=2, hidden_dim=64, nheads=4, dim_feedforward=128)
TOL = 1e-4


def tiny_stage1_configs(**kw):
    return (jcfg.stage1_config().model.replace(**TINY1),
            stage1_config(**TINY1, **kw))


def make_stage1_batch(seed, B=2, H=128, W=128, P=40, pad=(96, 80), n_valid=(30, 40)):
    """Packed uint8 images (image 1 padded to its top-left pad region),
    points inside each image's content, the first n_valid[i] valid, and
    target w, h."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8)
    mask = np.zeros((B, H, W), dtype=bool)
    mask[1, pad[0]:, :] = True
    mask[1, :, pad[1]:] = True
    raw[mask] = 0
    points = rng.uniform(0.05, 0.95, (B, P, 2)).astype(np.float32)
    valid = np.arange(P)[None, :] < np.asarray(n_valid)[:, None]
    whs = rng.uniform(0.03, 0.3, (B, P, 2)).astype(np.float32)
    return dict(images=pack_space_to_depth(raw), pad_mask=mask, points=points,
                points_valid=valid, whs=whs, batch_valid=np.ones(B, bool))


def jax_stage1_model_and_params(seed=0, cfg=None):
    cfg = cfg or tiny_stage1_configs()[0]
    model = JaxCountingDetr(cfg)
    b = make_stage1_batch(seed)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]),
        jnp.asarray(b["points"]), jnp.asarray(b["points_valid"]))
    return model, perturb(variables, seed)


@pytest.fixture(scope="module")
def stage1_reference():
    """The JAX model, its params and its forward on one batch."""
    jmodel, params = jax_stage1_model_and_params(seed=0)
    batch = make_stage1_batch(1)
    want = jax.jit(jmodel.apply)(params, *(jnp.asarray(batch[k]) for k in
                                           ("images", "pad_mask", "points", "points_valid")))
    return params, batch, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("variant", ["v3", "rank1"])
def test_stage1_forward_matches_jax(stage1_reference, variant):
    params, batch, want = stage1_reference
    model = build_model(tiny_stage1_configs(rcda_variant=variant)[1], device="cpu",
                        state_dict=params_from_jax(params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(batch[k]) for k in
                      ("images", "pad_mask", "points", "points_valid")))
    assert set(got) == set(want) == {"pred_logits", "pred_points", "pred_wh"}
    for key in want:
        g = got[key].numpy()
        assert g.shape == want[key].shape and g.dtype == np.float32, key
        np.testing.assert_allclose(g, want[key], atol=TOL, rtol=TOL, err_msg=key)


def test_stage1_params_load_strictly(stage1_reference):
    """A stage-1 tree maps onto the stage-1 model: input_proj in place of
    aggr_input_proj, no variance head, nothing missing or left over; the wh
    bias stays out of the bbox head's last bias."""
    params, _, _ = stage1_reference
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert "input_proj.0.0.weight" in sd and not any("aggr" in k or "variance" in k for k in sd)
    CountingDetr(tiny_stage1_configs()[1]).load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        sd["transformer.bbox_embed.0.layers.2.bias"].numpy(),
        np.asarray(params["params"]["transformer"]["bbox_embed"]["layers_2"]["bias"]))


def test_stage1_config_and_refusals():
    cfg = stage1_config()
    assert (cfg.stage, cfg.spatial_prior, cfg.num_query_pattern) == (1, "defined", 1)
    assert not cfg.with_variance_head and not cfg.exemplar_aggregation
    with pytest.raises(ValueError, match="rcda_variant"):
        stage1_config(rcda_variant="rank2")
    # the learned and sampled priors and aux_loss are in the port's model
    # (stage 1 returns no auxiliary outputs, as in the JAX package)
    for ok in (dict(spatial_prior="learned"), dict(spatial_prior="sampled"),
               dict(aux_loss=True)):
        model = CountingDetr(stage1_config(**TINY1, **ok))
        assert hasattr(model.transformer, "position") == (ok.get("spatial_prior") == "learned")
    # standard attention and three levels are in it too; the combinations
    # the JAX model cannot build raise ValueError
    for ok in (dict(attention_type="MHA"), dict(num_feature_levels=3), dict(masks=True)):
        CountingDetr(stage1_config(**TINY1, **ok))
    for bad in (dict(num_feature_levels=2), dict(num_feature_levels=3, masks=True),
                dict(num_feature_levels=3, attention_type="MHA")):
        with pytest.raises(ValueError, match="num_feature_levels"):
            CountingDetr(stage1_config(**TINY1, **bad))


def test_stage1_criterion_matches_jax(rng):
    B, Q = 3, 17
    pred_wh = rng.uniform(0.01, 0.5, (B, Q, 2)).astype(np.float32)
    points = rng.uniform(0.1, 0.9, (B, Q, 2)).astype(np.float32)
    whs = rng.uniform(0.01, 0.5, (B, Q, 2)).astype(np.float32)
    valid = rng.random((B, Q)) < 0.7
    valid[2] = False  # a batch-padding row: no valid query
    got = tlosses.stage1_criterion(*(torch.from_numpy(a) for a in (pred_wh, points, whs, valid)))
    want = jlosses.stage1_criterion(*(jnp.asarray(a) for a in (pred_wh, points, whs, valid)))
    for key in ("loss_wh", "loss_giou"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    # with no valid query anywhere both terms are 0, not NaN
    none = tlosses.stage1_criterion(*(torch.from_numpy(a) for a in
                                      (pred_wh, points, whs, np.zeros((B, Q), bool))))
    assert float(none["loss_wh"]) == 0.0 and float(none["loss_giou"]) == 0.0


def test_stage1_trainer_step_matches_jax():
    lr, lr_backbone = 1e-2, 1e-3
    jmodel_cfg, tmodel_cfg = tiny_stage1_configs()
    jmodel, params = jax_stage1_model_and_params(seed=2, cfg=jmodel_cfg)
    base = jcfg.stage1_config()
    cfg = base.replace(model=jmodel_cfg, train=base.train.replace(
        lr=lr, lr_backbone=lr_backbone, sgd=True))
    tx = jax_build_optimizer(cfg.train, params, steps_per_epoch=1)
    state, jm = make_train_step(jmodel, tx, cfg)(
        create_state(params, tx), {k: jnp.asarray(v) for k, v in make_stage1_batch(3).items()})

    trainer = Trainer(tmodel_cfg, TrainConfig(lr=lr, lr_backbone=lr_backbone, sgd=True),
                      device="cpu", state_dict=params_from_jax(params))
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    m = trainer.step(make_stage1_batch(3))
    assert int(trainer.bad_steps) == 0 and int(state.bad_steps) == 0
    # (grad_norm is not compared: the JAX package's spans the frozen tensors too)
    for key in ("loss", "loss_wh", "loss_giou"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    got, want = trainer.model.state_dict(), params_from_jax(state.params)
    moved = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=2e-6, rtol=0, err_msg=key)
        moved += not torch.equal(got[key], start[key])
    assert moved == len(trainer.params)

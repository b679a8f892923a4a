"""The port's stage-2 loss with auxiliary decoder losses against the JAX
package, on the CPU.

A tiny learned-prior or sampled-prior model (1+3 layers, hidden 32, 4
heads, ``aux_loss``) on perturbed JAX params mapped by ``params_from_jax``,
a batch with more targets than queries in one image (the transposed
auction) and fewer in the other, and for the sampled prior the batch's
``sampled_points``. Both sides match by the exact LAP (``exact_match``,
scipy on the host): the tiny random model's queries nearly tie, so the
eps-auction may settle on another eps-optimal assignment when the two
sides' costs differ by float32 noise (tests/test_torch_train.py measured
it), while the optimum of a generic cost is unique.

- ``stage2_loss``: every part (the last layer's and each earlier layer's
  ``loss_ce_{i}``/``loss_bbox_{i}``/``loss_giou_{i}``, each matched on its
  own) and the total within rtol 2e-4, the step-0 tolerance of
  tests/test_torch_train.py;
- the gradient of that total, aux terms included: the port's ``.grad``
  against ``jax.grad`` on every leaf the optimizer trains, within rtol 1e-4
  and an atol of 1e-4 of the leaf's largest entry;
- one ``Trainer.step`` against ``make_train_step``: the losses within rtol
  2e-4 and every parameter within 2 * lr (tests/test_torch_train.py's
  2 * steps * lr: Adam moves a weight with a near-zero gradient by up to lr
  either way, so this holds the update, not the gradient). The steps'
  ``grad_norm`` are not compared: JAX's counts the frozen leaves' gradients
  too, the port's only what it trains (151.875 against 151.809 on this
  step's batch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train.optimizer import _label as jax_label
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from countdetr_tpu.train.train_step import create_state, make_train_step
from countdetr_tpu.train.train_step import stage2_loss as jax_stage2_loss

from countdetr_tpu_torch.config import TrainConfig, stage2_config
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train.train_step import Trainer, prepare_stage2_batch, stage2_loss
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import perturb
from test_torch_train import leaves_by_name, make_train_batch, port_as_jax

TINY = dict(enc_layers=1, dec_layers=3, hidden_dim=32, nheads=4, dim_feedforward=64,
            num_query_position=25, num_query_pattern=1, aux_loss=True)
S = 24  # sampled points a image
PARTS = ["loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance", "class_error",
         "cardinality_error"] + [
    f"{k}_{i}" for i in range(TINY["dec_layers"] - 1)
    for k in ("loss_ce", "loss_bbox", "loss_giou")]


def configs(prior):
    return (jcfg.stage2_config().model.replace(spatial_prior=prior, **TINY),
            stage2_config(spatial_prior=prior, **TINY))


def batch_for(prior, seed):
    b = make_train_batch(seed)
    if prior == "sampled":
        rng = np.random.default_rng(70 + seed)
        b["sampled_points"] = rng.uniform(0.05, 0.95, (2, S, 2)).astype(np.float32)
        b["sampled_points_valid"] = np.ones((2, S), bool)
    return b


@functools.lru_cache(maxsize=None)
def jax_model_and_params(prior):
    jc, _ = configs(prior)
    model = JaxCountingDetr(jc)
    b = batch_for(prior, 0)
    pts = {}
    if prior == "sampled":
        pts = dict(points=jnp.asarray(b["sampled_points"]),
                   points_valid=jnp.asarray(b["sampled_points_valid"]))
    variables = jax.jit(lambda k: model.init(
        k, jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]),
        exemplar_boxes=jnp.asarray(b["exemplar_boxes"]), **pts))(jax.random.PRNGKey(4))
    return model, perturb(variables, 4)


@pytest.mark.parametrize("prior", ["learned", "sampled"])
def test_stage2_loss_with_aux_matches_jax(prior):
    jmodel, params = jax_model_and_params(prior)
    cfg = jcfg.stage2_config()
    cfg = cfg.replace(model=configs(prior)[0], train=cfg.train.replace(exact_match=True))
    b = batch_for(prior, 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["labels"] = jnp.zeros(b["boxes"].shape[:2], jnp.int32)
    _, want = jax.jit(lambda p, x: jax_stage2_loss(jmodel, p, x, cfg))(params, jb)

    model = build_model(configs(prior)[1], device="cpu", state_dict=params_from_jax(params))
    with torch.no_grad():
        _, got, _ = stage2_loss(model, prepare_stage2_batch(b, "cpu"),
                                TrainConfig(exact_match=True))
    assert set(got) == set(want) == set(PARTS)
    for k in PARTS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, err_msg=k)
    # the auxiliary terms count: the total is more than the last layer's
    last = (2 * got["loss_ce"] + 5 * got["loss_bbox"] + 2 * got["loss_giou"]
            + 2 * got["loss_variance"])
    assert float(got["loss"]) > float(last) + 1e-3


def test_trainer_step_with_aux_matches_jax():
    lr, lr_backbone = 1e-4, 1e-5
    jmodel, params = jax_model_and_params("learned")
    base = jcfg.stage2_config()
    cfg = base.replace(model=configs("learned")[0],
                       train=base.train.replace(lr=lr, lr_backbone=lr_backbone,
                                                exact_match=True))
    tx = jax_build_optimizer(cfg.train, params, steps_per_epoch=1)
    b = batch_for("learned", 2)
    state, jm = make_train_step(jmodel, tx, cfg)(create_state(params, tx),
                                                 {k: jnp.asarray(v) for k, v in b.items()})
    trainer = Trainer(configs("learned")[1],
                      TrainConfig(lr=lr, lr_backbone=lr_backbone, exact_match=True),
                      device="cpu", state_dict=params_from_jax(params))
    m = trainer.step(b)
    assert int(trainer.bad_steps) == 0 and int(state.bad_steps) == 0
    for k in PARTS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4, err_msg=k)
    got, want = port_as_jax(trainer.model, params), leaves_by_name(state.params)
    assert "['params']['position']" in want
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2 * lr, rtol=0, err_msg=key)
    moved = torch.ne(trainer.model.transformer.position.weight,
                     params_from_jax(params)["transformer.position.weight"])
    assert moved.all()  # the anchors learn


@pytest.mark.parametrize("prior", ["learned", "sampled"])
def test_stage2_aux_loss_gradients_match_jax(prior):
    """The gradient of the total, aux terms included, leaf by leaf: the
    port's ``.grad`` mapped to the JAX names against ``jax.grad`` of
    ``stage2_loss``, on every leaf the optimizer trains."""
    jmodel, params = jax_model_and_params(prior)
    cfg = jcfg.stage2_config()
    cfg = cfg.replace(model=configs(prior)[0], train=cfg.train.replace(exact_match=True))
    b = batch_for(prior, 3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["labels"] = jnp.zeros(b["boxes"].shape[:2], jnp.int32)
    grads = jax.jit(jax.grad(lambda p, x: jax_stage2_loss(jmodel, p, x, cfg)[0]))(params, jb)
    trained = {k for k, v in leaves_by_name(jax.tree_util.tree_map_with_path(
        lambda p, _: jax_label(p) != "frozen", params)).items() if v}

    model = build_model(configs(prior)[1], device="cpu", state_dict=params_from_jax(params))
    total, _, _ = stage2_loss(model, prepare_stage2_batch(b, "cpu"),
                              TrainConfig(exact_match=True))
    total.backward()
    with torch.no_grad():
        for p in model.parameters():  # the gradients in the weights' places
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    got, want = port_as_jax(model, params), leaves_by_name(grads)
    assert ("['params']['position']" in trained) == (prior == "learned")
    for key in sorted(trained):
        w = want[key]
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-3),
                                   err_msg=key)

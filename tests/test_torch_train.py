"""The port's stage-2 training against the JAX package, on the CPU.

(a) The attention cores' autograd Functions (kernel forward, backward
    recomputed through the plain core) against plain autograd and against
    jax.grad of the JAX einsum cores: float32, atol 1e-5.
(b) The update rule alone: identical synthetic gradients, on the tiny
    model's real parameter names, into the port's optimizer and into the
    JAX package's build_optimizer (AdamW groups, frozen set, torch-style
    clipping, StepLR with a drop inside the window): parameters within
    2e-6 after 10 steps (~1 float32 ulp a step of Adam accumulation).
(c) A 3-step Trainer trajectory against JAX make_train_step on the tiny
    model with more targets than queries: the same step-0 assignment, every
    loss term within rtol 2e-4 at step 0, the total loss within 1e-2 after
    (the assignment may then differ; see the test), the parameters within
    2 * steps * lr (Adam moves a parameter with a near-zero gradient by up
    to lr a step in either direction, so forward noise can flip it; the
    reasoning of tests/test_parity_training.py), frozen tensors unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.ops import losses as jlosses
from countdetr_tpu.ops import matching as jmatching
from countdetr_tpu.ops import rcda as jrcda
from countdetr_tpu.ops.pallas.mha_kernel import mha_core_einsum
from countdetr_tpu.train.checkpoints import torch_state_dict_to_params
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from countdetr_tpu.train.optimizer import make_schedule
from countdetr_tpu.train.train_step import create_state, make_train_step

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.models.transformer import WH_BIAS
from countdetr_tpu_torch.ops.kernels import mha_kernel, rcda_kernel
from countdetr_tpu_torch.train.optimizer import (
    build_optimizer, build_scheduler, clip_gradients, lr_factor,
)
from countdetr_tpu_torch.ops import losses as tlosses
from countdetr_tpu_torch.ops import matching as tmatching
from countdetr_tpu_torch.train.train_step import Trainer, prepare_stage2_batch, stage2_loss
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import jax_model_and_params, make_batch, tiny_configs
from test_torch_rcda import rcda_inputs

BBOX_LAST_BIAS = "transformer.bbox_embed.0.layers.2.bias"


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def leaves_by_name(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_as_jax(model, template):
    """The port's weights mapped back to the JAX package's params (its own
    importer takes the wh bias out of the bbox head again)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return leaves_by_name(torch_state_dict_to_params(sd, template, strict=True))


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("masked", [False, True])
def test_rcda_core_function_gradients(rng, masked):
    args = rcda_inputs(rng, 2, 30, 6, 5, 16, masked)
    cot = rng.normal(size=(2, 30, 16)).astype(np.float32)
    xs = [t(a).requires_grad_() for a in args[:5]]
    out = rcda_kernel.rcda_core(*xs, t(args[5]), t(args[6]), 4)
    assert type(out.grad_fn).__name__ == "RCDACoreBackward"
    got = torch.autograd.grad(out, xs, t(cot))
    ys = [t(a).requires_grad_() for a in args[:5]]
    plain = torch.autograd.grad(
        rcda_kernel.rcda_core_plain(*ys, t(args[5]), t(args[6]), 4), ys, t(cot))
    _, vjp = jax.vjp(lambda *a: jrcda._rcda_core_einsum(*a, jnp.asarray(args[5]),
                                                        jnp.asarray(args[6]), 4),
                     *(jnp.asarray(a) for a in args[:5]))
    want = vjp(jnp.asarray(cot))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    with torch.inference_mode():  # no graph, nothing saved
        assert rcda_kernel.rcda_core(*xs, t(args[5]), t(args[6]), 4).grad_fn is None


def test_mha_core_function_gradients(rng):
    B, L, S, n, d = 2, 12, 20, 2, 8
    q = rng.normal(size=(B, L, n * d)).astype(np.float32) * d**-0.5
    k, v = (rng.normal(size=(B, S, n * d)).astype(np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[0, S - 7:] = -1e30
    bias[1, :] = -1e30  # a fully masked row: the uniform softmax
    cot = rng.normal(size=(B, L, n * d)).astype(np.float32)
    xs = [t(a).requires_grad_() for a in (q, k, v)]
    out = mha_kernel.mha_core(*xs, t(bias), n)
    assert type(out.grad_fn).__name__ == "MHACoreBackward"
    got = torch.autograd.grad(out, xs, t(cot))
    ys = [t(a).requires_grad_() for a in (q, k, v)]
    plain = torch.autograd.grad(mha_kernel.mha_core_plain(*ys, t(bias), n), ys, t(cot))
    _, vjp = jax.vjp(lambda *a: mha_core_einsum(*a, jnp.asarray(bias), n),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(cot))
    for g, p, w in zip(got, plain, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    with torch.inference_mode():
        assert mha_kernel.mha_core(*xs, t(bias), n).grad_fn is None


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("sgd", [False, True])
def test_update_rule_matches_jax_optimizer(rng, sgd):
    lr, lr_backbone, wd, clip = 1e-2, 1e-3, 1e-4, 0.1
    steps, steps_per_epoch = 10, 4  # lr_drop=1: drops at steps 4 and 8
    _, params = jax_model_and_params(seed=3)
    jtrain = jcfg.stage2_config().train.replace(
        lr=lr, lr_backbone=lr_backbone, weight_decay=wd, clip_max_norm=clip, lr_drop=1, sgd=sgd)
    tx = jax_build_optimizer(jtrain, params, steps_per_epoch=steps_per_epoch)
    opt_state = tx.init(params)
    jax_update = jax.jit(lambda g, s, p: (lambda u, s2: (jax.tree_util.tree_map(
        lambda a, b: a + b, p, u), s2))(*tx.update(g, s, p)))

    model = build_model(tiny_configs()[1], device="cpu", state_dict=params_from_jax(params))
    cfg = TrainConfig(lr=lr, lr_backbone=lr_backbone, weight_decay=wd, clip_max_norm=clip,
                      lr_drop=1, sgd=sgd)
    opt = build_optimizer(model, cfg)
    sched = build_scheduler(opt, cfg, steps_per_epoch)
    named = dict(model.named_parameters())
    trainable = [p for p in named.values() if p.requires_grad]

    jparams = params
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 3.0).astype(np.float32), params)
        jparams, opt_state = jax_update(grads, opt_state, jparams)
        gsd = params_from_jax(grads)
        gsd[BBOX_LAST_BIAS] = gsd[BBOX_LAST_BIAS] - torch.tensor(WH_BIAS)  # a gradient, not a weight
        opt.zero_grad()
        for name, p in named.items():
            if p.requires_grad:
                p.grad = gsd[name].clone()
        clip_gradients(trainable, clip)
        opt.step()
        sched.step()

    got, want = port_as_jax(model, params), leaves_by_name(jparams)
    assert set(got) == set(want)
    # The port keeps the wh bias [0, 0, -2, -2] inside the bbox head's last
    # bias (as the reference does), so its weight decay also pulls on the
    # -2: lr * wd * 2 a step more than JAX's on that one tensor (AdamW),
    # or wd * 2 more in the gradient, carried on by the momentum (SGD).
    wh_drift, buf = 0.0, 0.0
    for s in range(steps):
        buf = 0.9 * buf + wd * 2.0 if sgd else wd * 2.0
        wh_drift += lr * 0.1 ** (s // steps_per_epoch) * buf
    for key, w in want.items():
        atol = 2e-6 + (wh_drift if "bbox_embed" in key and "layers_2" in key
                       and "bias" in key else 0.0)
        np.testing.assert_allclose(got[key], w, atol=atol, rtol=0, err_msg=key)
    frozen = [n for n, p in named.items() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.body.conv1", "backbone.body.layer1"))
                          for n in frozen)


@pytest.mark.parametrize("drop_epochs", [None, (1, 3)])
def test_lr_schedule_matches_jax(drop_epochs):
    """StepLR every lr_drop epochs, or MultiStepLR at the listed epochs,
    stepped per optimizer step (3 steps an epoch here)."""
    cfg = TrainConfig(lr_drop=2, lr_drop_epochs=drop_epochs)
    sched = make_schedule(1.0, 2, 3, drop_epochs=drop_epochs)
    got = [lr_factor(step, cfg, 3) for step in range(15)]
    np.testing.assert_allclose(got, [float(sched(step)) for step in range(15)], rtol=1e-6)
    assert len(set(got)) == 3


# ---------------------------------------------------------------- (c)


def make_train_batch(seed, T=32):
    packed, mask, rects = make_batch(seed)
    rng = np.random.default_rng(100 + seed)
    boxes = rng.uniform(0.2, 0.7, (2, T, 4)).astype(np.float32)
    boxes[..., 2:] = np.clip(boxes[..., 2:], 0.02, 0.2)
    valid = np.ones((2, T), bool)
    valid[1, 20:] = False  # 20 valid targets against 25 queries, 32 in image 0
    return dict(images=packed, pad_mask=mask, exemplar_boxes=rects, boxes=boxes,
                boxes_valid=valid, batch_valid=np.ones(2, bool))


def test_trainer_trajectory_matches_jax():
    steps, lr, lr_backbone = 3, 1e-4, 1e-5
    jmodel_cfg, tmodel_cfg = tiny_configs()
    jmodel, params = jax_model_and_params(seed=0, cfg=jmodel_cfg)
    base = jcfg.stage2_config()
    cfg = base.replace(model=jmodel_cfg, train=base.train.replace(
        lr=lr, lr_backbone=lr_backbone, lr_drop=2))
    tx = jax_build_optimizer(cfg.train, params, steps_per_epoch=1)
    state = create_state(params, tx)
    jstep = make_train_step(jmodel, tx, cfg)

    trainer = Trainer(tmodel_cfg, TrainConfig(lr=lr, lr_backbone=lr_backbone, lr_drop=2),
                      device="cpu", state_dict=params_from_jax(params), steps_per_epoch=1)
    frozen0 = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if k.startswith(("backbone.body.conv1", "backbone.body.layer1"))
               or k.endswith(("running_mean", "running_var")) or ".bn" in k
               or "downsample.1" in k}
    batches = [make_train_batch(s) for s in range(steps)]

    # the JAX step-0 assignment, as its train step computes it
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    out0 = jax.jit(jmodel.apply)(params, b0["images"], b0["pad_mask"],
                                 exemplar_boxes=b0["exemplar_boxes"])
    cost0 = jlosses.stage2_cost_matrix(out0["pred_logits"], out0["pred_boxes"], b0["boxes"],
                                       jnp.zeros((2, 32), jnp.int32))
    want_tq, want_m = (np.asarray(x) for x in jmatching.batched_match(cost0, b0["boxes_valid"]))
    # the port's, as its first step will compute it
    with torch.no_grad():
        _, _, match = stage2_loss(trainer.model, prepare_stage2_batch(batches[0], "cpu"),
                                  trainer.train_cfg)
    np.testing.assert_array_equal(match.matched.numpy(), want_m)
    np.testing.assert_array_equal(match.tgt2query.numpy()[want_m], want_tq[want_m])
    assert want_m.sum() == 25 + 20  # every query wins a target in image 0

    got_losses, want_losses = [], []
    for b in batches:
        m = trainer.step(b)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        got_losses.append({k: float(v) for k, v in m.items()})
        want_losses.append({k: float(v) for k, v in jm.items()})
    assert int(trainer.bad_steps) == 0 and int(state.bad_steps) == 0

    # After step 0 the two sides' weights differ by ~1e-7 and the random
    # tiny model's queries nearly tie, so the eps-auction may pick another
    # eps-optimal assignment (measured: 15% of the pairs at step 1, loss_bbox
    # 7% apart): the parts are compared at step 0, the total at every step.
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance"):
        np.testing.assert_allclose(got_losses[0][k], want_losses[0][k], rtol=2e-4, err_msg=k)
    for i, (g, w) in enumerate(zip(got_losses[1:], want_losses[1:]), 1):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-2, err_msg=f"step {i}")
    got, want = port_as_jax(trainer.model, params), leaves_by_name(state.params)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2 * steps * lr, rtol=0, err_msg=key)
    after = trainer.model.state_dict()
    assert frozen0 and all(torch.equal(after[k], v) for k, v in frozen0.items())
    moved = [n for n, p in trainer.model.named_parameters()
             if p.requires_grad and not torch.equal(p, params_from_jax(params)[n])]
    assert len(moved) == len(trainer.params)


def test_trainer_exact_match_takes_the_scipy_assignment():
    """TrainConfig(exact_match=True): the step matches by the host LAP."""
    train_cfg = TrainConfig(exact_match=True)
    trainer = Trainer(tiny_configs()[1], train_cfg, device="cpu", seed=2)
    batch = prepare_stage2_batch(make_train_batch(1), "cpu")
    with torch.no_grad():
        out = trainer.model(batch["images"], batch["pad_mask"], batch["exemplar_boxes"])
        cost = tlosses.stage2_cost_matrix(out["pred_logits"], out["pred_boxes"], batch["boxes"],
                                          batch["labels"])
        _, _, match = stage2_loss(trainer.model, batch, train_cfg)
    want_tq, want_m = tmatching.scipy_match(cost.numpy(), batch["boxes_valid"].numpy())
    np.testing.assert_array_equal(match.matched.numpy(), want_m)
    np.testing.assert_array_equal(match.tgt2query.numpy(), want_tq)
    assert want_m.sum() == 25 + 20
    metrics = trainer.step(make_train_batch(1))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(trainer.bad_steps) == 0


def test_trainer_eval_step_reports_losses_without_update():
    trainer = Trainer(tiny_configs()[1], TrainConfig(), device="cpu", seed=2)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got = trainer.eval_step(make_train_batch(0))
    assert all(bool(torch.isfinite(v)) for v in got.values())
    after = trainer.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    # the step that follows sees the same weights, match and losses
    stepped = trainer.step(make_train_batch(0))
    for k, v in got.items():
        np.testing.assert_allclose(float(stepped[k]), float(v), rtol=1e-6, err_msg=k)

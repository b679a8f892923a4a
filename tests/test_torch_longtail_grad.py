"""Gradients of the port's losses against ``jax.grad`` of the JAX package's,
on the CPU, for two of AnchorDETR's remaining options: three feature
levels under stage 1's loss (``countdetr_tpu/train/train_step.py::
stage1_loss``) and standard attention under stage 2's (``::stage2_loss``,
both sides on the exact LAP so the match is the same).

The params and batches are tests/test_torch_longtail.py's; both models run
with ``compute_dtype="float64"`` (JAX under ``enable_x64``), so no ReLU
input lies within rounding of zero in one framework and not in the other:
in float32 one such ReLU took the other side at this batch and moved one
output channel of ``layer4_1/conv1``'s gradient by 3.2e-4 of the leaf's
norm. The port's ``.grad`` of every leaf the JAX optimizer trains, mapped
back to the JAX names by the JAX importer, is held within 1e-4 of that
leaf's norm, a norm counted as at least 1e-4 of the largest leaf's: some
gradients are zero in exact arithmetic and float noise in both frameworks
(the input projections' conv biases, which a GroupNorm of one channel a
group removes: norms ~1e-10). The level embedding, level_fc, the level
layers and the 3x3 stride-2 projection of C3 are among the leaves. The
JAX gradient is jitted (the loss alone, not the train step): eagerly, JAX
compiles each op of the ResNet-50 forward and backward on its own, 60-90 s
a case on an 8-core CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train.optimizer import _label as jax_label
from countdetr_tpu.train.train_step import stage1_loss as jax_stage1_loss
from countdetr_tpu.train.train_step import stage2_loss as jax_stage2_loss

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train.train_step import (
    prepare_stage1_batch, prepare_stage2_batch, stage1_loss, stage2_loss,
)
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_longtail import configs, jax_model_params, make_inputs
from test_torch_train import leaves_by_name, port_as_jax

REL = 1e-4
# leaves that must be among those compared
MUST = {
    "levels-v3": ("['level_embed']", "['level_fc']", "['encoder_level_0']",
                  "['input_proj_0']['conv']['kernel']"),
    "mha-stage2": ("['encoder_0']['self_attn']", "['decoder_1']['cross_attn']"),
}


def batch_for(name, seed):
    x = make_inputs(name, seed)
    rng = np.random.default_rng(200 + seed)
    if configs(name)[1].stage == 1:
        b = {k: x[k] for k in ("images", "pad_mask", "points", "points_valid")}
        b["whs"] = rng.uniform(0.03, 0.3, x["points"].shape).astype(np.float32)
    else:
        T = 16
        boxes = rng.uniform(0.2, 0.7, (2, T, 4)).astype(np.float32)
        boxes[..., 2:] = np.clip(boxes[..., 2:], 0.02, 0.2)
        valid = np.ones((2, T), bool)
        valid[1, 10:] = False
        b = {k: x[k] for k in ("images", "pad_mask", "exemplar_boxes")}
        b.update(boxes=boxes, boxes_valid=valid)
    b["batch_valid"] = np.ones(2, bool)
    return b


@pytest.mark.parametrize("name", ["levels-v3", "mha-stage2"])
def test_loss_gradients_match_jax(name):
    _, params = jax_model_params(name)
    jc, pc = (c.replace(compute_dtype="float64") for c in configs(name))
    b = batch_for(name, 4)
    with jax.enable_x64():
        jmodel = JaxCountingDetr(jc)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if pc.stage == 1:
            cfg = jcfg.stage1_config().replace(model=jc)
            loss = lambda p: jax_stage1_loss(jmodel, p, jb, cfg)  # noqa: E731
        else:
            cfg = jcfg.stage2_config()
            cfg = cfg.replace(model=jc, train=cfg.train.replace(exact_match=True))
            jb["labels"] = jnp.zeros(b["boxes"].shape[:2], jnp.int32)
            loss = lambda p: jax_stage2_loss(jmodel, p, jb, cfg)  # noqa: E731
        (jtotal, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        jtotal, grads = float(jtotal), jax.tree_util.tree_map(np.asarray, grads)
    trained = {k for k, v in leaves_by_name(jax.tree_util.tree_map_with_path(
        lambda p, _: jax_label(p) != "frozen", params)).items() if v}

    model = build_model(pc, device="cpu", state_dict=params_from_jax(params))
    if pc.stage == 1:
        total, _ = stage1_loss(model, prepare_stage1_batch(b, "cpu"), TrainConfig())
    else:
        total, _, _ = stage2_loss(model, prepare_stage2_batch(b, "cpu"),
                                  TrainConfig(exact_match=True))
    total.backward()
    np.testing.assert_allclose(total.item(), jtotal, rtol=1e-6)
    with torch.no_grad():
        for p in model.parameters():  # the gradients in the weights' places
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    got, want = port_as_jax(model, params), leaves_by_name(grads)
    for part in MUST[name]:
        assert any(part in key for key in trained), part
    floor = REL * max(float(np.linalg.norm(want[k])) for k in trained)
    for key in sorted(trained):
        norm = float(np.linalg.norm(want[key]))
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= REL * max(norm, floor), (key, err, norm)

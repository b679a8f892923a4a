"""The port's engine loops against the JAX engine, on the CPU, on a
synthetic FSCD-147 tree (the port's generator, 96x128 images, 3-8 objects)
read raw uint8 and s2d-packed, with tiny models (hidden 32, 1+1 layers,
25 grid queries for stage 2) whose weights are random JAX params mapped
into the port by ``params_from_jax``.

- ``train_one_epoch``: two shuffled epochs of 2 steps at batch 3, every
  step logged, against the JAX ``train_one_epoch`` with its jitted step:
  steps and real samples equal; the mean loss within rtol 1e-2 (as
  tests/test_torch_train.py after step 0: the eps-auction may pick another
  eps-optimal assignment once the weights differ by float noise).
- ``evaluate`` on the initial weights: every loss within rtol 2e-4 (the
  step-0 tolerance of tests/test_torch_train.py).
- The NaN guard raises within its window, at the step JAX's does.
- ``infer_detections``, ``counting_summary``, ``stage1_test``: the same
  JSON images and annotation ids, counts and thresholds; boxes within 1 px
  (int() truncation of float32 values that differ in their last bits, as
  tests/test_torch_pseudo.py); scores within 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.data import batching as jbatching
from countdetr_tpu.data import fscd147 as jfscd
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train import engine as jengine
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from countdetr_tpu.train.train_step import (
    TrainState, create_state, make_eval_step, make_forward, make_train_step,
)

from countdetr_tpu_torch.config import TrainConfig, stage1_config, stage2_config
from countdetr_tpu_torch.data.batching import Batcher
from countdetr_tpu_torch.data.fscd147 import FSC147Pseudo, FSCD147Eval
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train import engine
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import perturb

TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64)
BUCKETS = ((96, 128),)
BS, MAX_BOXES, MAX_POINTS = 3, 16, 16
LR = dict(lr=1e-4, lr_backbone=1e-5, lr_drop=40)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_fscd147(str(tmp_path_factory.mktemp("fscd")), n_train=6, n_val=3,
                                  n_test=4, size=(96, 128), objects=(3, 8), seed=2)


def datasets(tree, cls_port, cls_jax, split):
    got, want = cls_port(tree, split), cls_jax(tree, split)
    got.host_normalize = want.host_normalize = False
    return got, want


def init_params(model, stage, seed):
    rng = np.random.default_rng(seed)
    images = jnp.asarray(rng.integers(0, 256, (2, 48, 64, 12), dtype=np.uint8))
    mask = jnp.zeros((2, 96, 128), bool)
    if stage == 1:
        extra = (jnp.full((2, 5, 2), 0.5), jnp.ones((2, 5), bool))
        variables = jax.jit(model.init)(jax.random.PRNGKey(seed), images, mask, *extra)
    else:
        variables = jax.jit(model.init)(jax.random.PRNGKey(seed), images, mask,
                                        exemplar_boxes=jnp.full((2, 3, 4), 0.3))
    return perturb(variables, seed)


@pytest.fixture(scope="module")
def stage2(tree):
    base = jcfg.stage2_config()
    jmodel_cfg = base.model.replace(num_query_position=25, **TINY)
    cfg = base.replace(model=jmodel_cfg, train=base.train.replace(**LR), data=base.data.replace(
        batch_size=BS, buckets=BUCKETS, max_boxes=MAX_BOXES, max_points=MAX_POINTS,
        num_workers=0, pack_s2d=True))
    jmodel = JaxCountingDetr(jmodel_cfg)
    params = init_params(jmodel, 2, 0)
    return jmodel, cfg, params, stage2_config(num_query_position=25, **TINY)


def batchers(tree, split, **kw):
    ds, jds = datasets(tree, FSC147Pseudo, jfscd.FSC147Pseudo, split)
    common = dict(max_boxes=MAX_BOXES, max_points=MAX_POINTS, pack_s2d=True, **kw)
    return (Batcher(ds, BS, BUCKETS, **common),
            jbatching.Batcher(jds, BS, BUCKETS, num_workers=0, **common))


def test_train_one_epoch_and_evaluate_match_jax(tree, stage2, capsys):
    jmodel, cfg, params, tcfg = stage2
    tb, jb = batchers(tree, "train", shuffle=True, seed=7)
    vb, jvb = batchers(tree, "val")
    steps = tb.num_batches()
    assert steps == jb.num_batches() == 2

    trainer = Trainer(tcfg, TrainConfig(**LR), device="cpu",
                      state_dict=params_from_jax(params), steps_per_epoch=steps)
    tx = jax_build_optimizer(cfg.train, params, steps_per_epoch=steps)
    state = create_state(params, tx)

    got_v, want_v = engine.evaluate(trainer, vb), jengine.evaluate(
        make_eval_step(jmodel, cfg), params, jvb, None)
    assert set(got_v) == set(want_v) and got_v["real_samples"] == want_v["real_samples"] == 3
    for k, w in want_v.items():
        np.testing.assert_allclose(got_v[k], w, rtol=2e-4, err_msg=k)

    jstep = make_train_step(jmodel, tx, cfg)
    for epoch in range(2):
        got = engine.train_one_epoch(trainer, tb, epoch, log_every=1)
        state, want = jengine.train_one_epoch(jstep, state, jb, None, epoch, log_every=1)
        assert set(got) == set(want)
        for k in ("epoch", "steps", "real_samples"):
            assert got[k] == want[k], k
        assert got["steps"] == 2 and got["real_samples"] == 6
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-2, err_msg=f"epoch {epoch}")
    assert int(trainer.bad_steps) == 0 and trainer.scheduler.last_epoch == 4
    assert capsys.readouterr().out.count("Epoch [1] [2]") == 2  # both loggers printed


class FakeTrainer:
    """A step whose loss stops being finite at ``bad_at``."""

    def __init__(self, bad_at):
        self.bad_at, self.steps = bad_at, 0
        self.bad_steps = torch.zeros((), dtype=torch.int32)

    def step(self, batch):
        loss = torch.tensor(float("inf") if self.steps >= self.bad_at else 1.0)
        self.steps += 1
        self.bad_steps += (~torch.isfinite(loss)).int()
        return {"loss": loss}


def fake_jax_step(bad_at, ran):
    def step(state, batch):
        ran.append(1)
        s = int(state.step)
        loss = jnp.float32(np.inf) if s >= bad_at else jnp.float32(1.0)
        bad = state.bad_steps + (~jnp.isfinite(loss)).astype(jnp.int32)
        return TrainState(state.params, state.opt_state, state.step + 1, bad), {"loss": loss}
    return step


@pytest.mark.parametrize("bad_at,n,log_every", [(3, 40, 100), (4, 5, 100), (2, 40, 4),
                                                (10 ** 9, 7, 100)])
def test_nan_guard_raises_within_its_window_as_jax(bad_at, n, log_every):
    batches = [{"images": np.zeros((1, 4, 4, 3), np.float32), "meta": [], "bucket": (4, 4)}
               for _ in range(n)]
    fake, ran = FakeTrainer(bad_at), []
    jstate = TrainState({}, {}, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    raised = []
    for run in (lambda: engine.train_one_epoch(fake, [dict(b) for b in batches], 0,
                                               log_every=log_every),
                lambda: jengine.train_one_epoch(fake_jax_step(bad_at, ran), jstate,
                                                [dict(b) for b in batches], None, 0,
                                                log_every=log_every)):
        try:
            run()
            raised.append(False)
        except FloatingPointError:
            raised.append(True)
    assert raised[0] == raised[1] == (bad_at < n)
    assert fake.steps == len(ran)  # both stopped at the same step
    if bad_at < n:
        assert fake.steps - bad_at <= min(10, log_every)


def port_model(params, cfg):
    return build_model(cfg, device="cpu", state_dict=params_from_jax(params))


def assert_coco_close(got, want, score_tol=None):
    assert got["box_format"] == want["box_format"] and got["images"] == want["images"]
    assert len(got["annotations"]) == len(want["annotations"]) > 0
    for a, b in zip(got["annotations"], want["annotations"]):
        skip = ("bbox", "area", "score", "point")
        assert {k: v for k, v in a.items() if k not in skip} == \
               {k: v for k, v in b.items() if k not in skip}
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1, rtol=0)
        if score_tol is not None:
            np.testing.assert_allclose(a["score"], b["score"], atol=score_tol, rtol=0)
            np.testing.assert_allclose(a["point"], b["point"], atol=1, rtol=0)


def test_infer_detections_and_counting_summary_match_jax(tree, stage2, tmp_path):
    jmodel, cfg, params, tcfg = stage2
    ds, jds = datasets(tree, FSCD147Eval, jfscd.FSCD147Eval, "test")
    want = jengine.infer_detections(make_forward(jmodel, cfg), params, jds, cfg,
                                    str(tmp_path / "jax.json"))
    got = engine.infer_detections(port_model(params, tcfg), ds, str(tmp_path / "port.json"),
                                  batch_size=BS, buckets=BUCKETS, max_boxes=MAX_BOXES,
                                  max_points=MAX_POINTS)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("image_id", "image_name", "count_pred", "count_gt"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["threshold"], w["threshold"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["boxes_cxcywh_px"], w["boxes_cxcywh_px"], atol=1e-2)
    assert_coco_close(json.loads((tmp_path / "port.json").read_text()),
                      json.loads((tmp_path / "jax.json").read_text()), score_tol=1e-5)
    got_c, want_c = engine.counting_summary(got), jengine.counting_summary(want)
    assert got_c == want_c and got_c["images"] == 4
    assert engine.counting_summary([{"count_gt": None, "count_pred": 3}]) == {}


def test_stage1_test_matches_jax(tree, tmp_path):
    base = jcfg.stage1_config()
    jmodel_cfg = base.model.replace(**TINY)
    cfg = base.replace(model=jmodel_cfg, data=base.data.replace(
        batch_size=BS, buckets=BUCKETS, max_boxes=MAX_BOXES, max_points=MAX_POINTS,
        num_workers=0, pack_s2d=True))
    jmodel = JaxCountingDetr(jmodel_cfg)
    params = init_params(jmodel, 1, 1)
    ds, jds = datasets(tree, FSCD147Eval, jfscd.FSCD147Eval, "test")
    jengine.stage1_test(make_forward(jmodel, cfg), params, jds, cfg, str(tmp_path / "jax.json"))
    out = engine.stage1_test(port_model(params, stage1_config(**TINY)), ds,
                             str(tmp_path / "port.json"), batch_size=BS, buckets=BUCKETS,
                             max_points=MAX_POINTS, max_boxes=MAX_BOXES,
                             vis_dir=str(tmp_path / "vis"))
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert out == str(tmp_path / "port.json") and got["box_format"] == "xywh"
    # top min(100, 16 queries x 2 classes) per image
    assert len(got["annotations"]) == 4 * 2 * MAX_POINTS
    assert_coco_close(got, want)
    assert sorted(p.name for p in (tmp_path / "vis").iterdir()) == \
        sorted(im["file_name"] for im in got["images"])

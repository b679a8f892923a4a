"""The sampled prior's data path and the reference's alternate matchers,
against the JAX package, on the CPU.

- The readers' ``sampled_points`` (FSCD147Eval, FSC147Pseudo), drawn from a
  density .npy where the tree has one and from the dots elsewhere: equal
  to the JAX readers' arrays (the same numpy draws).
- The Batcher's ``sampled_points``/``sampled_points_valid``, a partial
  batch included: equal to the JAX Batcher's.
- ``infer_detections`` under the sampled prior (tiny model, 1+1 layers,
  hidden 32, 16 points an image): counts, thresholds, scores and boxes as
  tests/test_torch_engine.py holds them (scores within 1e-5, JSON boxes
  within 1 px); without sampled points both engines raise ValueError.
- ``evaluate`` under the sampled prior: every loss within rtol 2e-4 (both
  sides match by the exact LAP, see tests/test_torch_aux_loss.py).
- The ``Predictor`` serves the sampled prior with points in the requests:
  counts equal, scores within 1e-5 of the JAX forward's.
- ``point_cost_matrix``, ``chamfer_match`` and ``chamfer_point_distance``
  within 1e-6 (argmins equal).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.data import batching as jbatching
from countdetr_tpu.data import fscd147 as jfscd
from countdetr_tpu.eval.postprocess import adaptive_threshold_counting
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.ops import matching as jmatching
from countdetr_tpu.train import engine as jengine
from countdetr_tpu.train.train_step import make_eval_step, make_forward

from countdetr_tpu_torch.config import TrainConfig, stage2_config
from countdetr_tpu_torch.data import fscd147 as tfscd
from countdetr_tpu_torch.data.batching import Batcher
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from countdetr_tpu_torch.ops import matching as tmatching
from countdetr_tpu_torch.serve import Predictor, pack_points, pack_requests
from countdetr_tpu_torch.train import engine
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_engine import assert_coco_close, port_model
from test_torch_model import perturb

N_SAMPLED = 16
TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64,
            spatial_prior="sampled", num_query_pattern=1)
BUCKETS = ((96, 128),)
BS, MAX_BOXES, MAX_POINTS = 3, 16, 16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree whose first test and train images have a density
    map (the others draw from their dots)."""
    root = make_synthetic_fscd147(str(tmp_path_factory.mktemp("fscd")), n_train=4, n_val=3,
                                  n_test=4, size=(96, 128), objects=(3, 8), seed=5)
    dens = os.path.join(root, "gt_density_map_adaptive_384_VarV2")
    os.makedirs(dens)
    splits = json.load(open(os.path.join(root, "Train_Test_Val_FSC_147.json")))
    rng = np.random.default_rng(0)
    for name in (splits["test"][0], splits["train"][0]):
        d = rng.random((96, 128)).astype(np.float32) ** 4
        np.save(os.path.join(dens, os.path.splitext(name)[0] + ".npy"), d)
    return root


def reader_pair(tree, name, split, n=N_SAMPLED):
    got = getattr(tfscd, name)(tree, split, num_sampled_points=n)
    want = getattr(jfscd, name)(tree, split, num_sampled_points=n)
    got.host_normalize = want.host_normalize = False
    return got, want


@pytest.mark.parametrize("name,split", [("FSCD147Eval", "test"), ("FSCD147Eval", "val"),
                                        ("FSC147Pseudo", "train")])
def test_readers_sampled_points_equal_jax(tree, name, split):
    got, want = reader_pair(tree, name, split)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert set(g) == set(w) and g["sampled_points"].shape == (N_SAMPLED, 2)
        np.testing.assert_array_equal(g["sampled_points"], w["sampled_points"])
        np.testing.assert_array_equal(g["image"], w["image"])
    # without the flag no reader draws
    assert "sampled_points" not in getattr(tfscd, name)(tree, split)[0]


def test_batcher_sampled_points_equal_jax(tree):
    ds, jds = reader_pair(tree, "FSCD147Eval", "test")
    kw = dict(max_boxes=MAX_BOXES, max_points=MAX_POINTS, pack_s2d=True)
    got = list(Batcher(ds, BS, BUCKETS, **kw))
    want = list(jbatching.Batcher(jds, BS, BUCKETS, num_workers=0, **kw))
    assert len(got) == len(want) == 2  # 4 images: the second batch is padded
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("sampled_points", "sampled_points_valid", "batch_valid", "images"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert all("sampled_points" not in m for m in g["meta"])
    assert not got[1]["sampled_points_valid"][1:].any()


@pytest.fixture(scope="module")
def sampled_model():
    base = jcfg.stage2_config()
    jmodel_cfg = base.model.replace(**TINY)
    cfg = base.replace(model=jmodel_cfg, train=base.train.replace(exact_match=True),
                       data=base.data.replace(batch_size=BS, buckets=BUCKETS,
                                              max_boxes=MAX_BOXES, max_points=MAX_POINTS,
                                              num_workers=0, pack_s2d=True,
                                              num_sampled_points=N_SAMPLED))
    jmodel = JaxCountingDetr(jmodel_cfg)
    rng = np.random.default_rng(3)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.asarray(rng.integers(0, 256, (2, 48, 64, 12), np.uint8)),
        jnp.zeros((2, 96, 128), bool), points=jnp.full((2, N_SAMPLED, 2), 0.5),
        points_valid=jnp.ones((2, N_SAMPLED), bool), exemplar_boxes=jnp.full((2, 3, 4), 0.3))
    return jmodel, cfg, perturb(variables, 3), stage2_config(**TINY)


def test_infer_detections_under_the_sampled_prior_matches_jax(tree, sampled_model, tmp_path):
    jmodel, cfg, params, tcfg = sampled_model
    ds, jds = reader_pair(tree, "FSCD147Eval", "test")
    want = jengine.infer_detections(make_forward(jmodel, cfg), params, jds, cfg,
                                    str(tmp_path / "jax.json"))
    model = port_model(params, tcfg)
    kw = dict(batch_size=BS, buckets=BUCKETS, max_boxes=MAX_BOXES, max_points=MAX_POINTS)
    got = engine.infer_detections(model, ds, str(tmp_path / "port.json"), **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("image_id", "count_pred", "count_gt"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["threshold"], w["threshold"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
    assert_coco_close(json.loads((tmp_path / "port.json").read_text()),
                      json.loads((tmp_path / "jax.json").read_text()), score_tol=1e-5)
    # a dataset that draws no points: both engines refuse
    bare, jbare = reader_pair(tree, "FSCD147Eval", "test", n=0)
    with pytest.raises(ValueError, match="sampled_points"):
        jengine.infer_detections(make_forward(jmodel, cfg), params, jbare, cfg, None)
    with pytest.raises(ValueError, match="sampled_points"):
        engine.infer_detections(model, bare, None, **kw)


def test_evaluate_under_the_sampled_prior_matches_jax(tree, sampled_model):
    jmodel, cfg, params, tcfg = sampled_model
    ds, jds = reader_pair(tree, "FSC147Pseudo", "val")
    kw = dict(max_boxes=MAX_BOXES, max_points=MAX_POINTS, pack_s2d=True)
    trainer = Trainer(tcfg, TrainConfig(exact_match=True), device="cpu",
                      state_dict=params_from_jax(params))
    got = engine.evaluate(trainer, Batcher(ds, BS, BUCKETS, **kw))
    want = jengine.evaluate(make_eval_step(jmodel, cfg), params,
                            jbatching.Batcher(jds, BS, BUCKETS, num_workers=0, **kw), None)
    assert set(got) == set(want) and got["real_samples"] == 3
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4, err_msg=k)


def test_predictor_serves_the_sampled_prior(sampled_model):
    jmodel, _, params, tcfg = sampled_model
    rng = np.random.default_rng(9)
    requests = []
    for h, w, n in ((90, 120, N_SAMPLED), (64, 96, N_SAMPLED - 5)):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        rects = np.array([[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.7], [0.2, 0.5, 0.4, 0.8]],
                         np.float32)
        requests.append((image, rects, rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)))
    pred = Predictor(tcfg, state_dict=params_from_jax(params), device="cpu", bucket=(96, 128))
    got = pred.predict(requests)
    images, masks, rects, _ = pack_requests(requests, (96, 128))
    points, valid = pack_points(requests)
    assert points.shape == (2, N_SAMPLED, 2) and valid.sum() == 2 * N_SAMPLED - 5
    out = jax.jit(jmodel.apply)(params, jnp.asarray(images), jnp.asarray(masks),
                                points=jnp.asarray(points), points_valid=jnp.asarray(valid),
                                exemplar_boxes=jnp.asarray(rects))
    prob = 1.0 / (1.0 + np.exp(-np.asarray(out["pred_logits"])[..., 0]))
    for i, r in enumerate(got):
        keep, thr = adaptive_threshold_counting(prob[i])
        assert r["count"] == int(keep.sum())
        np.testing.assert_allclose(r["scores"], prob[i][keep], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["threshold"], thr, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="points"):
        pred.predict([r[:2] for r in requests])


def test_point_cost_and_chamfer_match_jax(rng):
    B, Q, T = 3, 11, 7
    pred = rng.uniform(0.1, 0.9, (B, Q, 4)).astype(np.float32)
    tgt = rng.uniform(0.1, 0.9, (B, T, 4)).astype(np.float32)
    pred[..., 2:] *= 0.3
    tgt[..., 2:] *= 0.3
    got = tmatching.point_cost_matrix(torch.from_numpy(pred), torch.from_numpy(tgt))
    want = jmatching.point_cost_matrix(jnp.asarray(pred), jnp.asarray(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    for g, w in zip(tmatching.chamfer_match(got), jmatching.chamfer_match(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = rng.random((B, T)) < 0.6
    valid[2] = False  # no valid target
    for v in (None, valid):
        g = tmatching.chamfer_point_distance(
            torch.from_numpy(pred[..., :2]), torch.from_numpy(tgt[..., :2]),
            None if v is None else torch.from_numpy(v))
        w = jmatching.chamfer_point_distance(jnp.asarray(pred[..., :2]), jnp.asarray(tgt[..., :2]),
                                             None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)

"""The port's CLI modes against the JAX CLI's, on the CPU, on one synthetic
FSCD-147 tree (96x128 images, 3-8 objects) and tiny models (hidden 32,
1+1 layers; 25 grid queries for stage 2).

Random JAX params, perturbed, go once through the JAX package's
``save_checkpoint`` and once through ``weights.params_from_jax`` into a
port checkpoint; each CLI then runs, in this process, from its own
checkpoint with ``--checkpoint_path``:
  - stage 1 ``--generate_pseudo_label``: pseudo_bbox_{train,val,test}.json;
  - stage 1 ``--test``: pseudo_test_anchor_detr_v3.json;
  - stage 2 ``--infer``: predictions_{val,test}.json, metrics.json and
    report_{val,test}/.
And both import one reference-layout .pth with ``--checkpoint_path x.pth``
(strict), then run stage 1 ``--test``.
The JSONs hold the same images and annotation ids, boxes within 1 px (int()
truncation of float32 values that differ in their last bits, as
tests/test_torch_engine.py), the same counts per image and scores within
1e-5. AP, AP50 and the counting metrics agree within 1e-9 (measured: a
difference of 0.0 on every metric, with val AP 5.7e-4, since the counts
are equal and the boxes differ only by float32 noise).
The JAX CLI runs on the CPU as the JAX package's tests run it, over a
one-device mesh: on the tests' 8 virtual devices its restored params sit
on device 0 while it shards each batch over 8, and jit refuses the mix (a
JAX-only fault, ROADMAP.md Queue 3).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from countdetr_tpu.cli import main as jmain
from countdetr_tpu.core import mesh as jmesh
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train import checkpoints as jckpt
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from countdetr_tpu.train.train_step import create_state

from countdetr_tpu_torch.cli import main as tmain
from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_checkpoints import reference_pth
from test_torch_engine import assert_coco_close, init_params

TINY = ["--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "4",
        "--dim_feedforward", "64", "--buckets", "96x128", "--batch_size", "3",
        "--max_points", "16", "--max_boxes", "16", "--num_workers", "0"]
STAGE1 = ["--stage", "1", "--spatial_prior", "defined", "--num_query_pattern", "1",
          "--num_query_position", "3"]
STAGE2 = ["--stage", "2", "--spatial_prior", "grid", "--num_query_position", "25",
          "--num_query_pattern", "1", "--no_aux_loss"]
METRIC_TOL = 1e-9


@pytest.fixture(autouse=True)
def one_device_mesh(monkeypatch):
    make_mesh = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape=(-1,), axis_names=("data",),
                        devices=None: make_mesh((1,), axis_names, jax.devices()[:1]))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_fscd147(str(tmp_path_factory.mktemp("fscd")), n_train=4, n_val=3,
                                  n_test=3, size=(96, 128), objects=(3, 8), seed=6)


def parse(mod, argv):
    return mod.get_args_parser().parse_args(argv)


def checkpoints(tmp_path, tree, stage_argv, stage, seed):
    """(JAX checkpoint dir, port checkpoint dir) of the same random params,
    the model built from the JAX CLI's own config of these flags."""
    cfg = jmain.config_from_args(parse(jmain, ["--data_path", tree, "--output_dir", "x"]
                                       + TINY + stage_argv))
    params = init_params(JaxCountingDetr(cfg.model), stage, seed)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    state = create_state(params, jax_build_optimizer(cfg.train, params, 1))
    jckpt.save_checkpoint(jdir, 0, state, {"epoch": 0}, cfg=cfg)
    tcfg = tmain.config_from_args(parse(tmain, ["--data_path", tree, "--output_dir", "x"]
                                        + TINY + stage_argv))
    trainer = Trainer(tcfg.model, TrainConfig(), device="cpu",
                      state_dict=params_from_jax(jax.device_get(params)))
    ckpt.save_checkpoint(tdir, 0, trainer, {"epoch": 0})
    return jdir, tdir


def run_both(tmp_path, tree, stage_argv, stage, seed, mode_argv, pth=None):
    jdir, tdir = (pth, pth) if pth else checkpoints(tmp_path, tree, stage_argv, stage, seed)
    outs = {}
    for name, mod, ck in (("jax", jmain, jdir), ("port", tmain, tdir)):
        out = str(tmp_path / name)
        argv = (["--data_path", tree, "--output_dir", out, "--checkpoint_path", ck] + TINY
                + stage_argv + mode_argv)
        if mod is tmain:
            argv += ["--device", "cpu"]
        outs[name] = (out, mod.main(parse(mod, argv)))
    return outs


def load(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def per_image_counts(coco):
    counts = {}
    for a in coco["annotations"]:
        counts[a["image_id"]] = counts.get(a["image_id"], 0) + 1
    return counts


def test_generate_pseudo_label_matches_jax_cli(tree, tmp_path):
    outs = run_both(tmp_path, tree, STAGE1, 1, 3, ["--generate_pseudo_label"])
    (jout, _), (tout, _) = outs["jax"], outs["port"]
    with open(os.path.join(tree, "annotation_FSC147_384.json")) as f:
        dots = json.load(f)
    for split in ("train", "val", "test"):
        got, want = (load(o, f"pseudo_bbox_{split}.json") for o in (tout, jout))
        assert got["box_format"] == "cxcywh"
        assert_coco_close(got, want)
        counts = per_image_counts(got)
        assert counts == per_image_counts(want)
        for im in got["images"]:
            assert counts[im["id"]] == len(dots[im["file_name"]]["points"])


def test_stage1_test_matches_jax_cli(tree, tmp_path):
    outs = run_both(tmp_path, tree, STAGE1, 1, 4, ["--test"])
    (jout, _), (tout, _) = outs["jax"], outs["port"]
    got, want = (load(o, "pseudo_test_anchor_detr_v3.json") for o in (tout, jout))
    assert got["box_format"] == "xywh" and len(got["images"]) == 3
    assert_coco_close(got, want)
    assert per_image_counts(got) == per_image_counts(want)


def test_infer_matches_jax_cli(tree, tmp_path):
    outs = run_both(tmp_path, tree, STAGE2, 2, 5, ["--infer"])
    (jout, jmetrics), (tout, tmetrics) = outs["jax"], outs["port"]
    for split in ("val", "test"):
        got, want = (load(o, f"predictions_{split}.json") for o in (tout, jout))
        assert_coco_close(got, want, score_tol=1e-5)
        assert per_image_counts(got) == per_image_counts(want)
        for name in ("each_img_info.json", "worst_images.json"):
            g, w = (load(os.path.join(o, f"report_{split}"), name) for o in (tout, jout))
            assert [{k: v for k, v in r.items() if k not in ("AP", "AP50")} for r in g] == \
                [{k: v for k, v in r.items() if k not in ("AP", "AP50")} for r in w]
    assert load(tout, "metrics.json") == tmetrics
    assert tmetrics.keys() == jmetrics.keys() == {"val", "test"}
    for split in ("val", "test"):
        assert tmetrics[split].keys() == jmetrics[split].keys()
        assert tmetrics[split]["images"] == jmetrics[split]["images"] == 3
        for k, w in jmetrics[split].items():
            np.testing.assert_allclose(tmetrics[split][k], w, rtol=0, atol=METRIC_TOL,
                                       err_msg=f"{split} {k}")


def test_pth_import_then_stage1_test_matches_jax_cli(tree, tmp_path, capsys):
    cfg = tmain.config_from_args(parse(tmain, ["--data_path", tree, "--output_dir", "x"]
                                       + TINY + STAGE1))
    src = build_model(cfg.model, device="cpu", seed=9)
    with torch.no_grad():  # the reference's (1,) stage-1 class bias: equal biases
        src.transformer.cls_embed[0].bias.fill_(-4.5)
    pth = str(tmp_path / "ref.pth")
    reference_pth(src, pth, 1)
    outs = run_both(tmp_path, tree, STAGE1, 1, 0, ["--test"], pth=pth)
    assert capsys.readouterr().out.count(f"imported torch checkpoint {pth}") == 2
    got, want = (load(o, "pseudo_test_anchor_detr_v3.json") for o in (outs["port"][0],
                                                                   outs["jax"][0]))
    assert_coco_close(got, want)

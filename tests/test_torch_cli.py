"""The port's command line against the JAX CLI, on the CPU:

- the two parsers have the same flags: option strings, destinations,
  defaults, choices, nargs, types and actions, but for ``--device`` (the
  port's runs the model there; the JAX CLI ignores it);
- ``config_from_args`` gives the same config, field by field, on a set of
  command lines (the stage presets, --exact_replay, --lr_drop_epochs, the
  --cost_* aliases, --no_pack_s2d, --host_normalize, LVIS, the decoded
  caches), and ``build_dataset`` the same reader class;
- every model flag value runs the mode at a tiny width (the learned and
  sampled priors, a prior other than the stage's own, --aux_loss,
  --dropout, --masks, --attention_type nn.MultiheadAttention,
  --num_feature_levels 3), or raises where the JAX model asserts (the
  defined prior in stage 2 has no points to read); the combinations the
  JAX model cannot build (levels other than 1 or 3, levels in stage 2,
  with --masks or with standard attention) exit with a SystemExit that
  says why, before anything is written; a bare ``--stage 2`` trains and
  infers from its checkpoint; the process topology of one process is
  JAX's;
- ``evaluate_predictions``, ``per_image_ap`` and ``analyze_results`` of both
  packages agree to 1e-12 on the same predictions, for FSCD-147 and
  FSCD-LVIS (the same float64 arithmetic on both sides).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from countdetr_tpu.cli import main as jmain
from countdetr_tpu.cli import offline_eval as joffline
from countdetr_tpu.core import mesh as jmesh
from countdetr_tpu.data import fscd147 as jfscd
from countdetr_tpu.data import fscd_lvis as jlvis

from countdetr_tpu_torch.cli import main as tmain
from countdetr_tpu_torch.cli import offline_eval as toffline
from countdetr_tpu_torch.core import mesh as tmesh
from countdetr_tpu_torch.data import fscd147 as tfscd
from countdetr_tpu_torch.data import fscd_lvis as tlvis
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from synth_lvis import make_fscd_lvis

BASE = ["--data_path", "d", "--output_dir", "o"]
STAGE1 = ["--stage", "1", "--spatial_prior", "defined", "--num_query_pattern", "1",
          "--num_query_position", "3"]
STAGE2 = ["--stage", "2", "--spatial_prior", "grid", "--num_query_position", "600",
          "--num_query_pattern", "1", "--no_aux_loss"]
# fields one config has and the other has not
JAX_ONLY = {"model": {"use_pallas_rcda", "param_dtype", "remat"},
            "data": set(), "train": {"mesh_shape", "mesh_axes"}}
PORT_ONLY = {"model": {"rcda_variant"}, "data": set(), "train": set()}


def action_spec(a):
    return {"dest": a.dest, "default": a.default, "choices": a.choices, "nargs": a.nargs,
            "type": a.type, "const": a.const, "required": a.required,
            "action": type(a).__name__}


def test_parsers_have_the_same_flags():
    got = {tuple(a.option_strings): action_spec(a) for a in tmain.get_args_parser()._actions}
    want = {tuple(a.option_strings): action_spec(a) for a in jmain.get_args_parser()._actions}
    assert set(got) == set(want) and len(got) == 79
    for opts, spec in want.items():
        if opts == ("--device",):
            assert got[opts] == {**spec, "default": "cuda"}
            continue
        assert got[opts] == spec, opts
    assert ("--set_cost_giou", "--cost_giou") in got


def parse(mod, argv):
    return mod.get_args_parser().parse_args(BASE + argv)


@pytest.mark.parametrize("argv", [
    STAGE1,
    STAGE2 + ["--epochs", "1200"],
    STAGE2 + ["--exact_replay"],
    STAGE2 + ["--lr_drop_epochs", "400", "800", "--batch_size", "4", "--lr", "4e-4"],
    STAGE2 + ["--cost_class", "3", "--cost_bbox", "4", "--cost_giou", "1.5", "--sgd"],
    STAGE2 + ["--no_pack_s2d", "--compute_dtype", "bfloat16", "--max_steps", "50"],
    STAGE1 + ["--host_normalize", "--buckets", "96x128,128x128", "--max_points", "32"],
    STAGE2 + ["--dataset_file", "fscd_lvis", "--max_boxes", "64"],
    STAGE1 + ["--dataset_file", "fscd_lvis_point", "--generate_pseudo_label"],
    STAGE2 + ["--decoded_cache", "--num_workers", "4", "--seed", "7"],
    STAGE2 + ["--decoded_cache_dir", "/cache", "--cache_mode", "--sync_checkpoint",
              "--auto_resume", "--resume", "r", "--log_every", "5", "--no_dilation"],
    STAGE2 + ["--spatial_prior", "sampled", "--num_sample_points", "64"],
    ["--stage", "2"],
    STAGE2 + ["--aux_loss", "--dropout", "0.1", "--spatial_prior", "learned"],
    STAGE1 + ["--spatial_prior", "sampled", "--num_sample_points", "32", "--dropout", "0.2"],
    STAGE2 + ["--masks", "--attention_type", "nn.MultiheadAttention"],
    STAGE1 + ["--num_feature_levels", "3"],
], ids=["stage1", "stage2", "exact_replay", "lr_drop_epochs", "cost_aliases", "no_pack_s2d",
        "host_normalize", "lvis", "lvis_point", "decoded_cache", "decoded_cache_dir",
        "sampled", "bare_stage2", "aux_dropout", "stage1_sampled", "masks_mha", "levels"])
def test_config_from_args_matches_jax(argv):
    got = tmain.config_from_args(parse(tmain, argv))
    want = jmain.config_from_args(parse(jmain, argv))
    for part in ("model", "data", "train"):
        g, w = dataclasses.asdict(getattr(got, part)), dataclasses.asdict(getattr(want, part))
        assert set(g) - set(w) == PORT_ONLY[part] and set(w) - set(g) == JAX_ONLY[part]
        for k in set(g) & set(w):
            assert g[k] == w[k], (part, k)
    assert got.model.rcda_variant == "v3"
    assert got.model.num_queries == want.model.num_queries


@pytest.mark.parametrize("variant", ["v3", "rank1"])
def test_rcda_variant_comes_from_the_jax_switch(monkeypatch, variant):
    monkeypatch.setenv("COUNTDETR_PALLAS_VARIANT", variant)
    assert tmain.config_from_args(parse(tmain, STAGE1)).model.rcda_variant == variant
    monkeypatch.setenv("COUNTDETR_PALLAS_VARIANT", "v2")
    with pytest.raises(SystemExit, match="COUNTDETR_PALLAS_VARIANT"):
        tmain.config_from_args(parse(tmain, STAGE1))


def test_lr_group_names_refused_as_jax():
    argv = STAGE2 + ["--lr_backbone_names", "backbone.0"]
    for mod in (tmain, jmain):
        with pytest.raises(SystemExit, match="lr_backbone_names"):
            mod.config_from_args(parse(mod, argv))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runs below are tiny models, dispatch more than arithmetic: one
    intra-op thread spares them the thread pool's cost while the suite's
    other workers hold every core (they took ~50x their lone time there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_fscd147(str(tmp_path_factory.mktemp("fscd")), n_train=4, n_val=3,
                                  n_test=3, size=(96, 128), objects=(3, 8), seed=4)


@pytest.fixture(scope="module")
def lvis_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lvis"))
    make_fscd_lvis(root, n_per_split=4, seed=3)
    return root


@pytest.mark.parametrize("argv,reason", [
    (STAGE1 + ["--num_feature_levels", "2"], "must be 1 or 3"),
    (STAGE1 + ["--num_feature_levels", "4"], "must be 1 or 3"),
    (STAGE2 + ["--num_feature_levels", "3"], "excludes exemplar aggregation"),
    (STAGE1 + ["--num_feature_levels", "3", "--masks"], "masks exclude"),
    (STAGE1 + ["--num_feature_levels", "3", "--attention_type", "nn.MultiheadAttention"],
     "RCDA attention only"),
], ids=["two_levels", "four_levels", "levels_stage2", "levels_masks", "levels_mha"])
@pytest.mark.parametrize("mode", ["train", "--infer"])
def test_combinations_jax_cannot_build_exit_saying_why(tree, tmp_path, argv, reason, mode):
    """Each fails in the JAX model when it is built (an assert, or shapes
    that do not meet); the port's CLI exits first, writing nothing."""
    extra = [] if mode == "train" else [mode]
    args = tmain.get_args_parser().parse_args(
        ["--data_path", tree, "--output_dir", str(tmp_path), "--device", "cpu"] + argv + extra)
    with pytest.raises(SystemExit) as e:
        tmain.main(args)
    msg = str(e.value)
    assert msg.startswith("model flags: ") and reason in msg, msg
    assert not os.path.exists(tmp_path / "log.txt")


TINY_CLI = ["--enc_layers", "1", "--dec_layers", "2", "--hidden_dim", "32", "--nheads", "4",
            "--dim_feedforward", "64", "--buckets", "96x128", "--batch_size", "2",
            "--num_workers", "0", "--max_boxes", "16", "--max_points", "16", "--epochs", "1",
            "--max_steps", "1", "--log_every", "1"]


def run_cli(tree, out, argv):
    args = tmain.get_args_parser().parse_args(
        ["--data_path", tree, "--output_dir", str(out), "--device", "cpu"] + TINY_CLI + argv)
    return tmain.main(args)


@pytest.mark.parametrize("argv", [
    ["--stage", "2"],  # the parser's default prior: learned, 300 x 3 = 900 queries
    STAGE2 + ["--spatial_prior", "learned"],
    STAGE2 + ["--spatial_prior", "sampled", "--num_sample_points", "32"],
    # stage 1's criterion reads query i against point i: 16 grid queries, 16 points
    STAGE1[:2] + ["--spatial_prior", "grid", "--num_query_position", "16",
                  "--num_query_pattern", "1"],
    STAGE2[:2] + ["--spatial_prior", "defined"],
    STAGE2 + ["--aux_loss"],
    STAGE2 + ["--dropout", "0.1"],
    STAGE2 + ["--masks"],
    STAGE2 + ["--attention_type", "nn.MultiheadAttention"],
    STAGE1 + ["--num_feature_levels", "3"],
], ids=["default_prior", "learned", "sampled", "stage1_grid", "stage2_defined", "aux_loss",
        "dropout", "masks", "mha", "multilevel"])
@pytest.mark.parametrize("mode", ["train", "--infer"])
def test_flag_values_the_port_gained_run_the_mode(tree, tmp_path, argv, mode):
    """What the refusals of these values became: train takes its step and
    writes its log and checkpoint; --infer (stage 1: its --test) writes its
    predictions. Stage 2 under the defined prior raises as the JAX model
    asserts: no stage-2 dataset carries the points it reads. The model is
    the one the flags ask for (its mask head, standard attention, three
    levels)."""
    stage1 = argv[1] == "1"
    extra = [] if mode == "train" else ["--test" if stage1 else "--infer"]
    if "defined" in argv and not stage1:
        with pytest.raises(ValueError, match="the defined prior needs points"):
            run_cli(tree, tmp_path, argv + extra)
        return
    out = run_cli(tree, tmp_path, argv + extra)
    if mode == "train":
        cfg = out.cfg
        assert (cfg.masks, cfg.attention_type, cfg.num_feature_levels) == (
            "--masks" in argv, "MHA" if "nn.MultiheadAttention" in argv else "RCDA",
            3 if "--num_feature_levels" in argv else 1)
        assert hasattr(out.model, "mask_head") == cfg.masks
        assert out.scheduler.last_epoch == 1 and int(out.bad_steps) == 0
        log = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
        assert len(log) == 1 and np.isfinite(log[0]["loss"])
        if "--aux_loss" in argv:
            assert "loss_ce_0" in log[0] and "val_loss_giou_0" in log[0]
        assert (tmp_path / "checkpoints" / "latest.json").exists()
    elif stage1:
        assert (tmp_path / "pseudo_test_anchor_detr_v3.json").exists()
    else:
        assert set(out) == {"val", "test"} and out["test"]["images"] == 3
        assert (tmp_path / "predictions_test.json").exists()


def test_bare_stage2_trains_then_infers_from_its_checkpoint(tree, tmp_path):
    """The JAX CLI's default model: two steps, then --infer from the
    checkpoint, whose learned anchors moved off the seeded ones."""
    trainer = run_cli(tree, tmp_path, ["--stage", "2", "--max_steps", "2", "--epochs", "2"])
    assert trainer.cfg.spatial_prior == "learned" and trainer.cfg.num_queries == 900
    trained = trainer.model.transformer.position.weight.detach().clone()
    seeded = tmain.build_model(trainer.cfg, device="cpu", seed=42).transformer.position.weight
    assert not torch.equal(trained, seeded.detach())
    metrics = run_cli(tree, tmp_path, ["--stage", "2", "--infer", "--checkpoint_path",
                                       str(tmp_path / "checkpoints")])
    assert set(metrics) == {"val", "test"}
    preds = json.loads((tmp_path / "predictions_test.json").read_text())
    assert preds["box_format"] == "cxcywh" and len(preds["images"]) == 3


def test_backbone_other_than_resnet50_exits(tree, tmp_path):
    args = tmain.get_args_parser().parse_args(
        ["--data_path", tree, "--output_dir", str(tmp_path), "--device", "cpu", "--backbone",
         "resnet101"] + STAGE2)
    with pytest.raises(SystemExit, match="ResNet-50 only"):
        tmain.main(args)


def test_process_topology_is_single_process_jax(monkeypatch):
    assert tmesh.init_distributed() is False
    assert tmesh.is_main_process() and tmesh.process_index() == 0 and tmesh.process_count() == 1
    assert tmesh.is_main_process() == jmesh.is_main_process()
    stats = {"loss": np.float32(0.25), "loss_ce": 1.5, "epoch": 3, "real_samples": 7.0}
    got_stats, want_stats = dict(stats), dict(stats)
    got = tmesh.gather_metrics(got_stats, weight=got_stats.pop("real_samples", 1.0))
    want = jmesh.gather_metrics(want_stats, weight=want_stats.pop("real_samples", 1.0))
    assert got == want and got_stats == want_stats
    assert all(type(v) is float for v in got.values())
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="DDP"):
        tmesh.init_distributed()


@pytest.mark.parametrize("dataset_file", ["fscd_147", "fscd_lvis"])
def test_build_dataset_picks_the_jax_reader(tree, lvis_tree, dataset_file):
    root = tree if dataset_file == "fscd_147" else lvis_tree
    split = "val"
    for suffix, pseudo, stage in (("", False, 1), ("", True, 2), ("_point", False, 1),
                                  ("_test", False, 2)):
        argv = ["--data_path", root, "--output_dir", "o", "--stage", str(stage),
                "--dataset_file", dataset_file]
        cfg, jcfg = (m.config_from_args(m.get_args_parser().parse_args(argv))
                     for m in (tmain, jmain))
        if pseudo and dataset_file == "fscd_lvis":
            continue  # the LVIS tree has no pseudo labels before stage 1 writes them
        got = tmain.build_dataset(dataset_file + suffix, split, cfg, pseudo=pseudo)
        want = jmain.build_dataset(dataset_file + suffix, split, jcfg, pseudo=pseudo)
        assert type(got).__name__ == type(want).__name__
        assert got.host_normalize is want.host_normalize is False
        assert len(got) == len(want)


def fake_predictions(rng, gt_json, point_annos=None):
    """Jittered GT boxes with scores and a few false positives per image,
    as cxcywh pixel COCO predictions and as engine results."""
    images, annotations, results = [], [], []
    ann_id = 1
    for im in gt_json["images"]:
        gts = np.array([a["bbox"] for a in gt_json["annotations"]
                        if a["image_id"] == im["id"]], np.float64).reshape(-1, 4)
        n_fp = int(rng.integers(0, 4))
        xywh = np.concatenate([gts + rng.normal(0, 1.5, gts.shape),
                               rng.uniform(5, 60, (n_fp, 4))])
        keep = rng.random(len(xywh)) > 0.15
        xywh = xywh[keep]
        cxcywh = np.concatenate([xywh[:, :2] + xywh[:, 2:] / 2, xywh[:, 2:]], 1)
        scores = rng.uniform(0.3, 1.0, len(xywh))
        images.append({k: im[k] for k in ("id", "file_name", "height", "width")})
        for b, s in zip(cxcywh, scores):
            annotations.append({"id": ann_id, "image_id": im["id"], "bbox": b.tolist(),
                                "score": float(s), "category_id": 1})
            ann_id += 1
        n_gt = len(point_annos[im["file_name"]]["points"]) if point_annos else len(gts)
        results.append({"image_id": im["id"], "image_name": im["file_name"],
                        "count_pred": len(xywh), "count_gt": n_gt,
                        "boxes_cxcywh_px": cxcywh, "scores": scores})
    return {"images": images, "annotations": annotations, "box_format": "cxcywh"}, results


@pytest.mark.parametrize("dataset", ["fscd_147", "fscd_lvis"])
@pytest.mark.parametrize("split", ["val", "test"])
def test_offline_evaluator_matches_jax(tree, lvis_tree, tmp_path, dataset, split):
    rng = np.random.default_rng(11)
    lvis = dataset == "fscd_lvis"
    root = lvis_tree if lvis else tree
    gt_path = (os.path.join(root, "annotations", f"instances_{split}.json") if lvis
               else os.path.join(root, f"instances_{split}.json"))
    with open(gt_path) as f:
        gt = json.load(f)
    points = None
    if not lvis:
        with open(os.path.join(root, "annotation_FSC147_384.json")) as f:
            points = json.load(f)
    preds, results = fake_predictions(rng, gt, points)
    pred_path = str(tmp_path / "preds.json")
    with open(pred_path, "w") as f:
        json.dump(preds, f)

    got = toffline.evaluate_predictions(pred_path, root, dataset=dataset, split=split)
    want = joffline.evaluate_predictions(pred_path, root, dataset=dataset, split=split)
    assert set(got) == set(want) and "MAE" in got and ("MRE" in got) == ("MRE" in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-12, err_msg=k)
    assert 0.0 < got["AP"] <= 1.0

    ds = (tlvis.FSCDLvisEval if lvis else tfscd.FSCD147Eval)(root, split)
    jds = (jlvis.FSCDLvisEval if lvis else jfscd.FSCD147Eval)(root, split)
    by_name, jby_name = toffline._gt_xywh_by_name(ds), joffline._gt_xywh_by_name(jds)
    assert by_name.keys() == jby_name.keys()
    for k in by_name:
        np.testing.assert_array_equal(by_name[k], jby_name[k])
    got_ap, want_ap = (toffline.evaluate_results(results, ds),
                       joffline.evaluate_results(results, jds))
    for k, w in want_ap.items():
        np.testing.assert_allclose(got_ap[k], w, rtol=0, atol=1e-12, err_msg=k)
    got_img, want_img = toffline.per_image_ap(results, ds), joffline.per_image_ap(results, jds)
    assert got_img.keys() == want_img.keys() and len(got_img) == len(results)
    for name in want_img:
        for k in ("AP", "AP50"):
            np.testing.assert_allclose(got_img[name][k], want_img[name][k], rtol=0,
                                       atol=1e-12)
    got_w = toffline.analyze_results(results, str(tmp_path / "port"), worst_k=2,
                                     image_aps=got_img)
    want_w = joffline.analyze_results(results, str(tmp_path / "jax"), worst_k=2,
                                      image_aps=want_img)
    assert got_w == want_w and len(got_w) == 2
    for name in ("each_img_info.json", "worst_images.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())


def test_visualize_predictions_draws_as_jax(tree, tmp_path):
    rng = np.random.default_rng(5)
    with open(os.path.join(tree, "instances_test.json")) as f:
        preds, _ = fake_predictions(rng, json.load(f))
    pred_path = str(tmp_path / "preds.json")
    with open(pred_path, "w") as f:
        json.dump(preds, f)
    n = toffline.visualize_predictions(pred_path, tree, str(tmp_path / "port"), limit=2)
    assert n == joffline.visualize_predictions(pred_path, tree, str(tmp_path / "jax"),
                                               limit=2) == 2
    from PIL import Image

    for name in sorted(os.listdir(tmp_path / "jax")):
        a = np.asarray(Image.open(tmp_path / "port" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / name))
        np.testing.assert_array_equal(a, b)

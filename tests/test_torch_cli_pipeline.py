"""The whole two-stage pipeline through the port's CLI on the CPU
(``--device cpu``), tiny models on a synthetic FSCD-147 tree that has no
pseudo labels, so stage 1 must write them:

  stage-1 train -> --generate_pseudo_label into the tree's annotations/ ->
  stage-2 train for 2 epochs capped by --max_steps -> the same with
  --auto_resume and --epochs 3 -> --eval -> --infer -> --evaluate_predictions

Checks: finite losses in every log.txt line; the files each mode writes;
the pseudo-label count per image equal to its dots; --max_steps cuts the
second epoch; the resumed run starts at the saved epoch + 1 with the
optimizer step of the checkpoint; the offline evaluator's counting metrics
equal metrics.json's test entry (its AP is of the file's int() pixel boxes,
metrics.json's of the float ones, as in the JAX CLI); no worker process is
left behind by a mode.
"""

import json
import math
import multiprocessing
import os

import pytest

from countdetr_tpu_torch.cli import main as tmain
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147

TINY = ["--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "4",
        "--dim_feedforward", "64", "--buckets", "96x128", "--batch_size", "3",
        "--max_points", "16", "--max_boxes", "16", "--device", "cpu", "--log_every", "1"]
STAGE1 = ["--stage", "1", "--spatial_prior", "defined", "--num_query_pattern", "1",
          "--num_query_position", "3"]
STAGE2 = ["--stage", "2", "--spatial_prior", "grid", "--num_query_position", "25",
          "--num_query_pattern", "1", "--no_aux_loss"]


def run(tree, out, *argv, workers=0):
    args = tmain.get_args_parser().parse_args(
        ["--data_path", tree, "--output_dir", out, "--num_workers", str(workers)] + TINY
        + list(argv))
    result = tmain.main(args)
    assert multiprocessing.active_children() == []  # every worker pool closed
    return result


def log_lines(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        assert all(math.isfinite(v) for v in line.values() if isinstance(v, float)), line
    return lines


def test_two_stage_pipeline_through_the_cli(tmp_path, capsys):
    tree = make_synthetic_fscd147(str(tmp_path / "fscd"), n_train=6, n_val=3, n_test=3,
                                  size=(96, 128), objects=(3, 8), seed=8, with_pseudo=False)
    s1, s2 = str(tmp_path / "stage1"), str(tmp_path / "stage2")

    t1 = run(tree, s1, *STAGE1, "--epochs", "2", "--lr", "2e-3")
    lines = log_lines(s1)
    assert [x["epoch"] for x in lines] == [0, 1] and "loss_wh" in lines[0]
    assert t1.scheduler.last_epoch == 4  # 6 images at batch 3, two epochs

    ann = os.path.join(tree, "annotations")
    assert run(tree, ann, *STAGE1, "--generate_pseudo_label", "--resume",
               os.path.join(s1, "checkpoints")) is None
    with open(os.path.join(tree, "annotation_FSC147_384.json")) as f:
        dots = json.load(f)
    for split in ("train", "val", "test"):
        with open(os.path.join(ann, f"pseudo_bbox_{split}.json")) as f:
            pseudo = json.load(f)
        assert pseudo["box_format"] == "cxcywh" and len(pseudo["images"]) == 3 + 3 * (
            split == "train")
        assert len(pseudo["annotations"]) == sum(len(dots[im["file_name"]]["points"])
                                                 for im in pseudo["images"])

    capsys.readouterr()
    t2 = run(tree, s2, *STAGE2, "--epochs", "2", "--max_steps", "3", workers=2)
    lines = log_lines(s2)
    assert [x["epoch"] for x in lines] == [0, 1] and "val_loss_variance" in lines[0]
    assert t2.scheduler.last_epoch == 3  # 2 steps, then 1 of the second epoch
    ckpt_dir = os.path.join(s2, "checkpoints")
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        assert json.load(f) == {"step": 1}

    t3 = run(tree, s2, *STAGE2, "--epochs", "3", "--auto_resume", workers=2)
    assert "auto-resumed: continuing at epoch 2, optimizer step 3" in capsys.readouterr().out
    lines = log_lines(s2)
    assert [x["epoch"] for x in lines] == [0, 1, 2]
    assert t3.scheduler.last_epoch == 5
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        assert json.load(f) == {"step": 2}
    # retention keeps the newest committed checkpoint only
    assert sorted(os.listdir(ckpt_dir)) == ["checkpoint_2", "checkpoint_2.meta.json",
                                            "latest.json"]

    vstats = run(tree, s2, *STAGE2, "--eval", "--checkpoint_path", ckpt_dir)
    with open(os.path.join(s2, "eval.json")) as f:
        assert json.load(f) == vstats
    assert {"loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance"} <= set(vstats)
    assert all(math.isfinite(v) for v in vstats.values())

    metrics = run(tree, s2, *STAGE2, "--infer", "--checkpoint_path", ckpt_dir)
    for split in ("val", "test"):
        assert os.path.exists(os.path.join(s2, f"predictions_{split}.json"))
        assert sorted(os.listdir(os.path.join(s2, f"report_{split}"))) == [
            "each_img_info.json", "worst_images.json"]
        assert metrics[split]["images"] == 3
    with open(os.path.join(s2, "metrics.json")) as f:
        assert json.load(f) == metrics

    offline = run(tree, s2, "--evaluate_predictions",
                  os.path.join(s2, "predictions_test.json"), "--eval_split", "test")
    assert offline.keys() == metrics["test"].keys()
    for k in ("MAE", "RMSE", "NAE", "MRE", "SRE", "images"):
        assert offline[k] == metrics["test"][k], k
    assert 0.0 <= offline["AP"] <= 1.0


def test_training_without_a_val_split_and_sync_checkpoints(tmp_path):
    tree = make_synthetic_fscd147(str(tmp_path / "fscd"), n_train=3, n_val=1, n_test=1,
                                  size=(96, 128), objects=(3, 5), seed=9)
    os.remove(os.path.join(tree, "annotations", "pseudo_bbox_val.json"))
    out = str(tmp_path / "out")
    trainer = run(tree, out, *STAGE2, "--epochs", "2", "--sync_checkpoint", "--lr_drop", "1",
                  "--profile")
    assert trainer.scheduler.last_epoch == 2
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    lines = log_lines(out)
    assert [x["epoch"] for x in lines] == [0, 1] and not any("val_loss" in x for x in lines)
    with open(os.path.join(out, "checkpoints", "latest.json")) as f:
        assert json.load(f) == {"step": 1}
    # the lr drops tenfold at each epoch edge: a hundredth of --lr after two
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6)

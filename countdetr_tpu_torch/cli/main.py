"""The command line of the port (countdetr_tpu/cli/main.py): one entry point
for the whole two-stage pipeline, with the JAX CLI's flags.

  stage 1 train   : --stage 1 --spatial_prior defined --num_query_pattern 1
                    --num_query_position 3 (reference weakly_supervise_fscd_147.sh)
  stage 1 pseudo  : the same + --generate_pseudo_label (train/val/test dots)
  stage 1 test    : the same + --test
  stage 2 train   : --stage 2 --spatial_prior grid --num_query_position 600
                    --num_query_pattern 1 (reference var_wh_laplace_600.sh)
  stage 2 eval    : + --eval (the losses over val)
  stage 2 infer   : + --infer --checkpoint_path DIR
  offline eval    : --evaluate_predictions predictions.json

    python -m countdetr_tpu_torch.cli.main --stage 2 --spatial_prior grid \\
        --num_query_position 600 --num_query_pattern 1 --data_path D \\
        --output_dir O --compute_dtype bfloat16

A bare ``--stage 2`` runs the JAX CLI's default model: the learned prior
of 300 positions x 3 patterns (900 queries). Every prior runs in either
stage; the sampled prior reads --num_sample_points density-drawn points a
FSCD-147 image. Runs on ``--device`` (default cuda; a missing card raises,
nothing falls back). The model's RCDA core is COUNTDETR_PALLAS_VARIANT
("v3", the default, or "rank1"), the switch the JAX package reads. Every
model flag value of the JAX CLI runs: --attention_type
nn.MultiheadAttention, --num_feature_levels 3 (stage 1) and --masks too.
The combinations the JAX model cannot build exit with the reason
(``ModelConfig.check_options``): --num_feature_levels other than 1 or 3,
levels with stage 2's exemplar aggregation, with --masks, with standard
attention or without --dilation.

Data parallelism: ``torchrun --nproc_per_node=N -m countdetr_tpu_torch.cli.main
...`` trains on N processes, each on its card (cuda:LOCAL_RANK; NCCL, or
gloo where processes share a card, core/mesh.py) and its slice of each
global batch of N x --batch_size samples, with the losses of the global
batch (train/train_step.py); --eval runs the same way. Rank 0 prints,
writes log.txt and the checkpoints. The inference modes (--infer, --test,
--generate_pseudo_label) have no process stride, as in the JAX CLI: in a
world of more than one process they exit with the reason; run them in
one.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from countdetr_tpu_torch.cli import offline_eval
from countdetr_tpu_torch.config import RCDA_VARIANTS, Config, DataConfig, ModelConfig, TrainConfig
from countdetr_tpu_torch.core.mesh import (
    gather_metrics, init_distributed, is_main_process, local_device, mesh_dims, process_count,
    process_index, shutdown,
)
from countdetr_tpu_torch.data.batching import Batcher
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.train import engine
from countdetr_tpu_torch.train.train_step import Trainer

def get_args_parser():
    p = argparse.ArgumentParser("Counting-DETR on CUDA", add_help=False)
    # optimization (reference main.py:29-45)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=1e-5, type=float)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--max_steps", default=0, type=int,
                   help="stop training after N steps of this run (0 = unlimited)")
    p.add_argument("--lr_drop", default=20, type=int)
    p.add_argument("--lr_drop_epochs", default=None, type=int, nargs="+",
                   help="explicit drop epochs (MultiStepLR; overrides the periodic --lr_drop, "
                   "reference 2nd-stage main.py:39)")
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--sgd", action="store_true")
    # parameter groups: the port's optimizer splits 'backbone' from the
    # rest; other name lists are refused (reference 2nd-stage main.py:31-34)
    p.add_argument("--lr_backbone_names", default=["backbone"], type=str, nargs="+")
    p.add_argument("--lr_linear_proj_names", default=[], type=str, nargs="+")
    p.add_argument("--lr_linear_proj_mult", default=0.1, type=float)

    # model (reference main.py:52-95)
    p.add_argument("--backbone", default="resnet50", type=str)
    p.add_argument("--dilation", dest="dilation", action="store_true", default=True)
    p.add_argument("--no_dilation", dest="dilation", action="store_false")
    p.add_argument("--num_feature_levels", default=1, type=int)
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.0, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_query_position", default=300, type=int)
    p.add_argument("--num_query_pattern", default=3, type=int)
    p.add_argument("--spatial_prior", default="learned",
                   choices=["learned", "grid", "defined", "sampled"])
    p.add_argument("--attention_type", default="RCDA", choices=["RCDA", "nn.MultiheadAttention"])
    p.add_argument("--stage", default=1, type=int, choices=[1, 2])
    p.add_argument("--masks", action="store_true",
                   help="the DETRsegm mask head (not in the port's model yet)")
    p.add_argument("--aux_loss", dest="aux_loss", action="store_true", default=False)
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")

    # loss coefficients (reference main.py:96-121); the stage-2 tree's
    # --cost_* spellings of the matcher costs are accepted too
    p.add_argument("--set_cost_class", "--cost_class", dest="set_cost_class", default=2,
                   type=float)
    p.add_argument("--set_cost_bbox", "--cost_bbox", dest="set_cost_bbox", default=5, type=float)
    p.add_argument("--set_cost_giou", "--cost_giou", dest="set_cost_giou", default=2, type=float)
    # parsed and inert, as in the reference (2nd-stage main.py:110-115,126-131)
    p.add_argument("--chamfer_point_cost", default=1, type=float)
    p.add_argument("--chamfer_giou_cost", default=1, type=float)
    p.add_argument("--mask_loss_coef", default=1, type=float)
    p.add_argument("--dice_loss_coef", default=1, type=float)
    p.add_argument("--point_loss_coef", default=5, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="where the model runs: 'cuda' (the default; a missing card raises) or "
                   "'cpu' (the kernels' plain PyTorch versions)")
    p.add_argument("--remove_difficult", action="store_true")
    p.add_argument("--cls_loss_coef", default=2, type=float)
    p.add_argument("--bbox_loss_coef", default=5, type=float)
    p.add_argument("--giou_loss_coef", default=2, type=float)
    p.add_argument("--variance_loss_coef", default=2, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)

    # dataset
    p.add_argument("--dataset_file", default="fscd_147",
                   choices=["fscd_147", "fscd_147_point", "fscd_147_test", "fscd_lvis",
                            "fscd_lvis_point", "fscd_lvis_test"])
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--output_dir", required=True, type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--sync_checkpoint", action="store_true",
                   help="block the epoch loop on checkpoint writes instead of writing them "
                   "behind it (AsyncSaver)")
    p.add_argument("--checkpoint_path", default="", type=str)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--scale_factor", default=32, type=int)
    p.add_argument("--num_sample_points", default=300, type=int,
                   help="points drawn for --spatial_prior sampled (reference "
                   "data/fsc147.py:127 hardcodes 300)")
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--cache_mode", action="store_true",
                   help="cache raw image bytes in RAM (reference --cache_mode)")
    p.add_argument("--decoded_cache", action="store_true",
                   help="cache resized uint8 images in RAM: epoch 2+ skip the JPEG decode")
    p.add_argument("--decoded_cache_dir", default="", type=str,
                   help="an on-disk resized-uint8 cache shared by the worker processes and by "
                   "runs; overrides --decoded_cache/--cache_mode")
    p.add_argument("--host_normalize", action="store_true",
                   help="ImageNet-normalize images on the host as float32 (the reference "
                   "pipeline). Default: raw resized uint8, normalized on the device. "
                   "--exact_replay implies it")
    p.add_argument("--no_pack_s2d", action="store_true",
                   help="do not space-to-depth pack batched images on the host (B,H/2,W/2,12); "
                   "packing is already off under --host_normalize / --exact_replay")
    p.add_argument("--profile", action="store_true",
                   help="take a torch.profiler trace of the first training epoch into "
                   "{output_dir}/profile/trace.json (Chrome trace format)")
    p.add_argument("--log_every", default=100, type=int)

    # modes
    p.add_argument("--vis_pseudo", action="store_true",
                   help="draw generated pseudo/predicted boxes onto images")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--generate_pseudo_label", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--infer", action="store_true")
    p.add_argument("--use_predefined_points", action="store_true",
                   help="accepted and inert, as in the reference (infer.py:243-244)")
    p.add_argument("--evaluate_predictions", default="", type=str,
                   help="offline evaluator: path to predictions json")
    p.add_argument("--eval_split", default="test", choices=["val", "test"],
                   help="GT split for --evaluate_predictions")

    # additions of the accelerator packages
    p.add_argument("--exact_replay", action="store_true",
                   help="reference-exact schedule replay: batch size 1, the host pipeline's "
                   "normalization, no packing, and matching by scipy's exact LAP on the host "
                   "instead of the device auction. Without it, scale --lr linearly with "
                   "--batch_size from the reference's 1e-4 at batch 1.")
    p.add_argument("--buckets", default="384x384,384x512,384x672", type=str)
    p.add_argument("--max_points", default=700, type=int)
    p.add_argument("--max_boxes", default=700, type=int)
    p.add_argument("--compute_dtype", default="float32", type=str)
    p.add_argument("--matmul_precision", default="default", choices=["default", "high", "highest"],
                   help="float32 matmuls and convolutions: 'high' allows TF32 in both "
                   "(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32 "
                   "True), 'highest' forbids it (both False), 'default' leaves torch's own "
                   "settings as they are (TF32 off for matmuls, on for cuDNN convolutions)")
    return p


def _rcda_variant() -> str:
    v = os.environ.get("COUNTDETR_PALLAS_VARIANT", "v3")
    if v not in RCDA_VARIANTS:
        raise SystemExit(f"COUNTDETR_PALLAS_VARIANT={v!r}: the port's RCDA cores are "
                         f"{RCDA_VARIANTS}")
    return v


def config_from_args(args) -> Config:
    model = ModelConfig(
        backbone=args.backbone,
        dilation=bool(args.dilation),
        num_feature_levels=args.num_feature_levels,
        hidden_dim=args.hidden_dim,
        nheads=args.nheads,
        enc_layers=args.enc_layers,
        dec_layers=args.dec_layers,
        dim_feedforward=args.dim_feedforward,
        dropout=args.dropout,
        attention_type="RCDA" if args.attention_type == "RCDA" else "MHA",
        num_query_position=args.num_query_position,
        num_query_pattern=args.num_query_pattern,
        spatial_prior=args.spatial_prior,
        stage=args.stage,
        masks=args.masks,
        with_variance_head=args.stage == 2,
        exemplar_aggregation=args.stage == 2,
        aux_loss=args.aux_loss,
        compute_dtype=args.compute_dtype,
        rcda_variant=_rcda_variant(),
    )
    buckets = tuple(tuple(int(v) for v in b.split("x")) for b in args.buckets.split(","))
    data = DataConfig(
        dataset="fscd_lvis" if "lvis" in args.dataset_file else "fscd_147",
        data_path=args.data_path,
        scale_factor=args.scale_factor,
        batch_size=1 if args.exact_replay else args.batch_size,
        num_workers=args.num_workers,
        cache_mode=args.cache_mode,
        decoded_cache=args.decoded_cache,
        decoded_cache_dir=args.decoded_cache_dir,
        host_normalize=bool(args.host_normalize or args.exact_replay),
        pack_s2d=not bool(args.host_normalize or args.exact_replay or args.no_pack_s2d),
        num_sampled_points=args.num_sample_points if args.spatial_prior == "sampled" else 0,
        max_points=args.max_points,
        max_boxes=args.max_boxes,
        buckets=buckets,
    )
    if args.lr_backbone_names != ["backbone"] or args.lr_linear_proj_names:
        raise SystemExit(
            "--lr_backbone_names/--lr_linear_proj_names: only the reference defaults "
            "(['backbone'] / []) map onto the port's parameter groups, the fixed "
            "backbone/rest split (train/optimizer.py)")
    train = TrainConfig(
        lr=args.lr,
        lr_backbone=args.lr_backbone,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        max_steps=args.max_steps,
        lr_drop=args.lr_drop,
        lr_drop_epochs=tuple(args.lr_drop_epochs) if args.lr_drop_epochs else None,
        clip_max_norm=args.clip_max_norm,
        sgd=args.sgd,
        seed=args.seed,
        cls_loss_coef=args.cls_loss_coef,
        bbox_loss_coef=args.bbox_loss_coef,
        giou_loss_coef=args.giou_loss_coef,
        variance_loss_coef=args.variance_loss_coef,
        focal_alpha=args.focal_alpha,
        set_cost_class=args.set_cost_class,
        set_cost_bbox=args.set_cost_bbox,
        set_cost_giou=args.set_cost_giou,
        exact_match=args.exact_replay,
        output_dir=args.output_dir,
        resume=args.resume,
        auto_resume=args.auto_resume,
        async_checkpoint=not args.sync_checkpoint,
        log_every=args.log_every,
    )
    return Config(model=model, data=data, train=train)


def refuse_unsupported(args, cfg: Config):
    """SystemExit for a combination of model flags the JAX model cannot
    build, with the reason, and for a backbone other than ResNet-50."""
    m = cfg.model
    try:
        m.check_options()
    except ValueError as e:
        raise SystemExit(f"model flags: {e}") from None
    if m.backbone != "resnet50":
        raise SystemExit(f"--backbone {m.backbone}: the port, like the JAX package, builds "
                         f"ResNet-50 only")


def set_matmul_precision(precision: str):
    """--matmul_precision on torch's TF32 switches ('default' leaves them)."""
    import torch

    if precision != "default":
        tf32 = precision == "high"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


def _image_dir(cfg: Config) -> str:
    return (os.path.join("images", "all_images") if cfg.data.dataset == "fscd_lvis"
            else "images_384_VarV2")


def _cache_mode(cfg: Config):
    d = cfg.data
    return ("disk:" + d.decoded_cache_dir if d.decoded_cache_dir else
            "decoded" if d.decoded_cache else d.cache_mode)


def build_dataset(name: str, split: str, cfg: Config, pseudo: bool = False):
    ds = _build_dataset(name, split, cfg, pseudo)
    ds.host_normalize = cfg.data.host_normalize  # raw uint8 unless --host_normalize
    return ds


def _build_dataset(name: str, split: str, cfg: Config, pseudo: bool = False):
    dp, sf, cm = cfg.data.data_path, cfg.data.scale_factor, _cache_mode(cfg)
    if cfg.data.dataset == "fscd_147":
        from countdetr_tpu_torch.data import fscd147 as D

        nsp = cfg.data.num_sampled_points  # the sampled prior's points
        if pseudo:
            return D.FSC147Pseudo(dp, split, sf, num_sampled_points=nsp, cache_mode=cm)
        if name.endswith("_point"):
            return D.FSCD147Points(dp, split, sf, cache_mode=cm)
        if name.endswith("_test"):
            return D.FSCD147Eval(dp, split, sf, num_sampled_points=nsp, cache_mode=cm)
        return D.FSCD147Exemplars(dp, split, sf, cache_mode=cm)
    from countdetr_tpu_torch.data import fscd_lvis as D

    if pseudo:
        return D.FSCDLvisPseudo(dp, split, sf, cache_mode=cm)
    if name.endswith("_point"):
        return D.FSCDLvisPoints(dp, split, sf, cache_mode=cm)
    if name.endswith("_test"):
        # stage 2 evaluates on the single-instances GT where the tree has it
        # (reference lvis_2nd data/fscd_lvis.py:101-103)
        single = cfg.model.stage == 2 and os.path.exists(
            os.path.join(dp, "annotations", f"single_instances_{split}.json"))
        return D.FSCDLvisEval(dp, split, sf, single_instances=single, cache_mode=cm)
    return D.FSCDLvisExemplars(dp, split, sf, cache_mode=cm)


def get_sha() -> str:
    """The git state banner (reference util/misc.py:255-273)."""
    import subprocess

    cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.check_output(["git", "rev-parse", "HEAD"], cwd=cwd,
                                      stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "sha: unknown"
    dirty = "clean"
    try:
        subprocess.check_output(["git", "diff-index", "--quiet", "HEAD"], cwd=cwd,
                                stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        dirty = "has uncommitted changes"
    return f"sha: {sha} ({dirty})"


def _numeric(v) -> bool:
    return isinstance(v, (int, float, np.floating))


def main(args):
    """Run the mode ``args`` selects. Returns the offline metrics, the infer
    metrics by split, the eval losses, or in training the Trainer."""
    init_distributed(args.device)
    if is_main_process():
        print(get_sha())
    set_matmul_precision(args.matmul_precision)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = config_from_args(args)
    if cfg.model.spatial_prior == "sampled" and cfg.data.dataset == "fscd_lvis":
        raise SystemExit(
            "--spatial_prior sampled needs density-drawn points, which only the FSCD-147 "
            "datasets emit (the reference's sampled prior is a 147 2nd-stage capability, "
            "data/fsc147.py:259-284)")

    if args.evaluate_predictions:
        metrics = offline_eval.evaluate_predictions(
            args.evaluate_predictions, cfg.data.data_path, dataset=cfg.data.dataset,
            split=args.eval_split)
        if is_main_process():
            print(json.dumps(metrics, indent=2))
        return metrics

    refuse_unsupported(args, cfg)
    if process_count() > 1 and (args.generate_pseudo_label or args.test or args.infer):
        raise SystemExit(
            f"--infer, --test and --generate_pseudo_label run in one process: they have no "
            f"process stride (nor in the JAX CLI), and this is a world of {process_count()}")
    device = local_device(args.device)
    B, buckets = cfg.data.batch_size, cfg.data.buckets
    loader_kw = dict(batch_size=B, buckets=buckets, max_points=cfg.data.max_points,
                     num_workers=cfg.data.num_workers, pack_s2d=cfg.data.pack_s2d)
    model = build_model(cfg.model, device=device, seed=cfg.train.seed)

    # weights for the modes that read them; in training, a --resume
    # directory restores the optimizer, scheduler and epoch too (below)
    training_mode = not (args.generate_pseudo_label or args.test or args.infer or args.eval)
    if args.checkpoint_path or args.resume:
        path = args.checkpoint_path or args.resume
        if path.endswith(".pth"):
            # strict: a reference key the mapping leaves unconsumed raises here
            model.load_state_dict(ckpt.load_torch_checkpoint(path, model))
            if is_main_process():
                print(f"imported torch checkpoint {path}")
        elif not (training_mode and args.resume and not args.checkpoint_path):
            step = ckpt.latest_step(path)
            if step is not None:
                ckpt.restore_weights(path, step, model)
                if is_main_process():
                    print(f"restored {path} step {step}")

    if args.generate_pseudo_label:
        lvis = cfg.data.dataset == "fscd_lvis"
        for split in ("train", "val", "test"):
            ds = build_dataset(args.dataset_file + "_point", split, cfg)
            # 147 consumers read pseudo_bbox_{split}.json; LVIS ones
            # pseudo_lvis_{split}_cxcywh.json, with an xywh twin
            if lvis:
                out = os.path.join(args.output_dir, f"pseudo_lvis_{split}_cxcywh.json")
                xywh = os.path.join(args.output_dir, f"pseudo_lvis_{split}_xywh.json")
            else:
                out, xywh = os.path.join(args.output_dir, f"pseudo_bbox_{split}.json"), None
            engine.generate_pseudo_labels(model, ds, out, also_xywh_path=xywh, **loader_kw)
            print(f"wrote {out}")
            if args.vis_pseudo:
                n = offline_eval.visualize_predictions(
                    out, cfg.data.data_path, os.path.join(args.output_dir, "vis_pseudo", split),
                    image_dir=_image_dir(cfg))
                print(f"visualized {n} images")
        return None

    if args.test and cfg.model.stage == 1:
        # GT box centres as the anchors, the top 100 boxes of each image
        # (reference 1st-stage engine.py:190-265)
        ds = build_dataset(args.dataset_file + "_test", "test", cfg)
        out = os.path.join(args.output_dir, "pseudo_test_anchor_detr_v3.json")
        vis = os.path.join(args.output_dir, "vis_res") if args.vis_pseudo else None
        engine.stage1_test(model, ds, out, max_boxes=cfg.data.max_boxes, vis_dir=vis,
                           **loader_kw)
        print(f"wrote {out}")
        return None

    if args.infer or args.test:
        all_metrics = {}
        for split in ("val", "test"):
            ds = build_dataset(args.dataset_file + "_test", split, cfg)
            out = os.path.join(args.output_dir, f"predictions_{split}.json")
            results = engine.infer_detections(model, ds, out, max_boxes=cfg.data.max_boxes,
                                              **loader_kw)
            counting = engine.counting_summary(results)
            gt_by_name = offline_eval._gt_xywh_by_name(ds)  # built once, used twice
            ap = offline_eval.evaluate_results(results, ds, by_name=gt_by_name)
            offline_eval.analyze_results(
                results, os.path.join(args.output_dir, f"report_{split}"),
                image_aps=offline_eval.per_image_ap(results, ds, by_name=gt_by_name))
            if args.vis_pseudo:
                offline_eval.visualize_predictions(
                    out, cfg.data.data_path, os.path.join(args.output_dir, "vis_res", split),
                    image_dir=_image_dir(cfg))
            all_metrics[split] = {**counting, **ap}
            print(split, json.dumps(all_metrics[split], indent=2))
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(all_metrics, f, indent=2)
        return all_metrics

    if args.eval:
        # the criterion over the val split (reference main.py:240-247)
        val_ds = build_dataset(args.dataset_file, "val", cfg, pseudo=cfg.model.stage == 2)
        vb = Batcher(val_ds, B, buckets, max_points=cfg.data.max_points,
                     max_boxes=cfg.data.max_boxes, pack_s2d=cfg.data.pack_s2d,
                     **stride(cfg.train))
        trainer = Trainer(cfg.model, cfg.train, device=device, state_dict=model.state_dict(),
                          distributed=process_count() > 1)
        del model
        vstats = engine.evaluate(trainer, vb)
        vstats = gather_metrics(vstats, weight=vstats.pop("real_samples", 1.0))
        if is_main_process():
            print(json.dumps(vstats, indent=2))
            with open(os.path.join(args.output_dir, "eval.json"), "w") as f:
                json.dump(vstats, f, indent=2)
        return vstats

    return _train(args, cfg, model)


def _train(args, cfg: Config, model):
    train_ds = build_dataset(args.dataset_file, "train", cfg, pseudo=cfg.model.stage == 2)
    val_ds = None
    try:
        val_ds = build_dataset(args.dataset_file, "val", cfg, pseudo=cfg.model.stage == 2)
    except (FileNotFoundError, KeyError):
        pass
    # stage-2 box capacity tiers: dense images reach the matcher with all
    # their boxes (the reference's scipy LAP sees every target) while a few
    # capacities bound the distinct shapes
    mb = cfg.data.max_boxes
    box_tiers = (tuple(sorted({min(mb, 128), mb, max(8 * mb, 4096)}))
                 if cfg.model.stage == 2 else None)
    d = cfg.data
    batcher = Batcher(train_ds, d.batch_size, d.buckets, max_points=d.max_points,
                      max_boxes=d.max_boxes, shuffle=True, seed=cfg.train.seed,
                      box_tiers=box_tiers, num_workers=d.num_workers, pack_s2d=d.pack_s2d,
                      **stride(cfg.train))
    # the exact steps an epoch (the same on every rank: the schedule is
    # global), so a StepLR boundary lands on an epoch edge
    trainer = Trainer(cfg.model, cfg.train, device=next(model.parameters()).device,
                      state_dict=model.state_dict(), steps_per_epoch=max(batcher.num_batches(), 1),
                      distributed=process_count() > 1)
    del model
    start_epoch = args.start_epoch
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    keep = dict(keep_last=cfg.train.checkpoint_keep_last,
                keep_every=cfg.train.checkpoint_keep_every)
    saver = ckpt.AsyncSaver(**keep) if cfg.train.async_checkpoint else None

    def full_restore(directory: str, label: str) -> bool:
        """Weights, AdamW moments, the scheduler's position (the optimizer
        step) and the epoch (reference main.py:217-238)."""
        nonlocal start_epoch
        step = ckpt.latest_step(directory)
        if step is None:
            return False
        meta = ckpt.restore_checkpoint(directory, step, trainer)
        start_epoch = meta.get("epoch", 0) + 1
        if is_main_process():
            print(f"{label}: continuing at epoch {start_epoch}, optimizer step "
                  f"{meta['opt_step']}")
        return True

    resumed = args.auto_resume and full_restore(ckpt_dir, "auto-resumed")
    if not resumed and args.resume and not args.resume.endswith(".pth"):
        full_restore(args.resume, f"resumed {args.resume}")

    log_path = os.path.join(args.output_dir, "log.txt")
    # built once: a Batcher per epoch would start a new worker pool each time
    vb = None if val_ds is None else Batcher(
        val_ds, d.batch_size, d.buckets, max_points=d.max_points, max_boxes=d.max_boxes,
        box_tiers=box_tiers, num_workers=d.num_workers, pack_s2d=d.pack_s2d,
        **stride(cfg.train))
    steps_done = 0
    try:
        for epoch in range(start_epoch, cfg.train.epochs):
            if cfg.train.max_steps and steps_done >= cfg.train.max_steps:
                if is_main_process():
                    print(f"max_steps {cfg.train.max_steps} reached; stopping")
                break
            prof = None
            if args.profile and epoch == start_epoch and is_main_process():
                prof = _start_profile(trainer.device)
            t0 = time.time()
            stats = engine.train_one_epoch(
                trainer, batcher, epoch, cfg.train.log_every,
                prefetch_depth=max(args.num_workers, 1),
                max_steps=cfg.train.max_steps - steps_done if cfg.train.max_steps else None)
            steps_done += int(stats.pop("steps", 0))
            stats["epoch_time_s"] = time.time() - t0
            if prof is not None:
                prof.stop()
                path = os.path.join(args.output_dir, "profile", "trace.json")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                prof.export_chrome_trace(path)
                print(f"profile trace: {path}")
            # the train and val means are gathered apart, each with its own
            # real-sample weight (the identity in one process)
            host_weight = float(stats.pop("real_samples", 1.0))
            stats = {**gather_metrics({k: v for k, v in stats.items() if _numeric(v)},
                                      weight=host_weight),
                     **{k: v for k, v in stats.items() if not _numeric(v)}}
            if vb is not None:
                vstats = engine.evaluate(trainer, vb)
                vstats = gather_metrics(vstats, weight=float(vstats.pop("real_samples", 1.0)))
                stats.update({f"val_{k}": v for k, v in vstats.items()})
            if is_main_process():
                with open(log_path, "a") as f:
                    f.write(json.dumps({k: float(v) if _numeric(v) else v
                                        for k, v in stats.items()}) + "\n")
            if (epoch + 1) % cfg.train.checkpoint_every == 0 or epoch == cfg.train.epochs - 1:
                if saver is not None:
                    saver.save(ckpt_dir, epoch, trainer, {"epoch": epoch})
                else:
                    ckpt.save_checkpoint(ckpt_dir, epoch, trainer, {"epoch": epoch}, **keep)
        if saver is not None:
            # commit the write in flight and publish latest.json before a
            # follow-on invocation reads the directory
            saver.finalize()
    finally:
        batcher.close()
        if vb is not None:
            vb.close()
    if is_main_process():
        print("training done")
    return trainer


def stride(train_cfg) -> dict:
    """A Batcher's process stride: this rank's slice of each global batch,
    by its index on the mesh's data axis (core/mesh.py: rank = d * M + m)."""
    D, M = mesh_dims(train_cfg.mesh_shape, train_cfg.mesh_axes)
    return {"process_index": process_index() // M, "process_count": D}


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def cli_entry():
    parser = argparse.ArgumentParser("Counting-DETR on CUDA", parents=[get_args_parser()])
    try:
        main(parser.parse_args())
    finally:
        shutdown()


if __name__ == "__main__":
    cli_entry()

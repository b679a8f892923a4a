"""The learning-loop check of the PyTorch port: the two-stage pipeline
trained on synthetic FSCD-147 data until it detects, the port's counterpart
of tests/convergence_run.py with the same recipe.

Stage 1 learns the synthetic objects' (w, h) from 3 exemplars, labels every
dot with a pseudo box, stage 2 trains on the pseudo boxes, and the
detections of the train and held-out test splits go through the offline
evaluator. The model is tiny (2+2 layers, hidden 64, 4 heads, 96x128
images, batch 3, 25 grid queries); the data is ``tests/synth.py``'s
``make_fscd147`` (numpy and Pillow only). The port alone is imported.

    python tests/torch_convergence_run.py [--device cuda] [--dtype bfloat16]
        [--steps1 300] [--steps2 1500] [--lr2 1e-3]

prints one line per 100 stage-2 steps and ``FINAL {json}`` with, per split,
the counting metrics, AP, AP50 and MAE@0.5 (the count of scores at or
above 0.5 against the dots: the adaptive 2n-1 rule keeps ~2n boxes on a
calibrated model by construction, so the strict count is the criterion, as
in tests/convergence_run.py). tests/test_torch_convergence.py and
chip_smoke.py's ``convergence`` phase hold it to the JAX bounds: test AP50
> 0.5, test MAE@0.5 < 1.0, train AP50 > 0.5.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

DIMS = dict(enc_layers=2, dec_layers=2, hidden_dim=64, nheads=4, dim_feedforward=128)
BUCKETS = ((96, 128),)
B = 3
# the data: tests/convergence_run.py's (48 train images, one object size)
TREE = dict(n_train=48, n_val=4, n_test=8, fixed_obj_size=(14, 10))
BOUNDS = {"test_AP50_above": 0.5, "test_MAE@0.5_below": 1.0, "train_AP50_above": 0.5}


def within_bounds(summary) -> bool:
    return (summary["test"]["AP50"] > BOUNDS["test_AP50_above"]
            and summary["test"]["MAE@0.5"] < BOUNDS["test_MAE@0.5_below"]
            and summary["train"]["AP50"] > BOUNDS["train_AP50_above"])


def _steps(trainer, batcher, n, log=None):
    """n steps over the batcher's epochs; (first loss, last loss)."""
    done, first, m = 0, None, None
    while done < n:
        for batch in batcher:
            batch.pop("meta"), batch.pop("bucket")
            m = trainer.step(batch)
            done += 1
            if first is None:
                first = float(m["loss"])
            if log and done % 100 == 0:
                log(done, m)
            if done >= n:
                break
    if int(trainer.bad_steps) > 0:
        raise FloatingPointError(f"{int(trainer.bad_steps)} non-finite steps")
    return first, float(m["loss"])


def run(root: str, out_dir: str, steps1: int = 300, steps2: int = 1500, lr2: float = 1e-3,
        device: str = "cuda", dtype: str = "bfloat16", exact_match: bool = False,
        seed: int = 0, clip_max_norm: float = 0.1):
    """The recipe of tests/convergence_run.py::run on the port; returns
    {"train": {...}, "test": {...}, "seconds": {...}, "losses": {...}}.
    ``exact_match`` matches stage 2 by scipy's exact LAP on the host
    instead of the auction; ``seed`` offsets both stages' weight seeds and
    the Batchers' shuffles (0: the recipe's); ``clip_max_norm`` is stage
    2's gradient clip (0.1: the recipe's)."""
    from countdetr_tpu_torch.cli.offline_eval import evaluate_predictions
    from countdetr_tpu_torch.config import TrainConfig, stage1_config, stage2_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.data.fscd147 import (
        FSC147Pseudo, FSCD147Eval, FSCD147Exemplars, FSCD147Points,
    )
    from countdetr_tpu_torch.train import engine
    from countdetr_tpu_torch.train.train_step import Trainer

    seconds, losses = {}, {}
    # ---- stage 1: lr 1e-3, no LR drop
    t = time.perf_counter()
    trainer1 = Trainer(stage1_config(compute_dtype=dtype, **DIMS),
                       TrainConfig(lr=1e-3, lr_drop=10**6), device=device, seed=seed,
                       steps_per_epoch=10**6)
    b1 = Batcher(FSCD147Exemplars(root, "train"), B, BUCKETS, max_points=16, shuffle=True,
                 seed=seed)
    losses["stage1"] = _steps(trainer1, b1, steps1)
    seconds["stage1"] = time.perf_counter() - t
    print(f"stage1: loss {losses['stage1'][0]:.4f} -> {losses['stage1'][1]:.4f} "
          f"over {steps1} steps", flush=True)

    # ---- pseudo labels of the train and test dots
    t = time.perf_counter()
    os.makedirs(os.path.join(out_dir, "annotations"), exist_ok=True)
    for split in ("train", "test"):
        engine.generate_pseudo_labels(
            trainer1.model, FSCD147Points(root, split),
            os.path.join(out_dir, "annotations", f"pseudo_bbox_{split}.json"),
            batch_size=B, buckets=BUCKETS, max_points=16, pack_s2d=False)
    seconds["pseudo_labels"] = time.perf_counter() - t
    del trainer1

    # ---- stage 2: 25 grid queries, up to 36 boxes an image
    t = time.perf_counter()
    trainer2 = Trainer(stage2_config(num_query_position=25, compute_dtype=dtype, **DIMS),
                       TrainConfig(lr=lr2, lr_drop=10**6, exact_match=exact_match,
                                   clip_max_norm=clip_max_norm),
                       device=device, seed=seed + 1,
                       steps_per_epoch=10**6)
    ds2 = FSC147Pseudo(root, "train", pseudo_file=os.path.join(
        out_dir, "annotations", "pseudo_bbox_train.json"))
    b2 = Batcher(ds2, B, BUCKETS, max_boxes=36, shuffle=True, seed=seed)

    def log(step, m):
        parts = {k: round(float(m[k]), 4) for k in ("loss", "loss_ce", "loss_bbox",
                                                     "loss_giou", "loss_variance",
                                                     "cardinality_error", "grad_norm")}
        print(f"stage2 step {step}: {parts}", flush=True)

    losses["stage2"] = _steps(trainer2, b2, steps2, log)
    seconds["stage2"] = time.perf_counter() - t

    # ---- inference and the offline evaluation of both splits
    t = time.perf_counter()
    summary = {}
    for split in ("train", "test"):
        pred_path = os.path.join(out_dir, f"predictions_{split}.json")
        results = engine.infer_detections(trainer2.model, FSCD147Eval(root, split), pred_path,
                                          batch_size=B, buckets=BUCKETS, max_boxes=36,
                                          max_points=16, pack_s2d=False)
        metrics = evaluate_predictions(pred_path, root, split=split)
        errs = [abs(int((np.asarray(r["scores"]) >= 0.5).sum()) - r["count_gt"])
                for r in results if r["count_gt"] is not None]
        summary[split] = {**engine.counting_summary(results), "AP": metrics["AP"],
                          "AP50": metrics["AP50"],
                          "MAE@0.5": float(np.mean(errs)) if errs else float("nan")}
        print(f"{split}: {json.dumps(summary[split])}", flush=True)
    seconds["evaluate"] = time.perf_counter() - t
    summary["seconds"], summary["losses"] = seconds, losses
    print("FINAL", json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps1", type=int, default=300)
    ap.add_argument("--steps2", type=int, default=1500)
    ap.add_argument("--lr2", type=float, default=1e-3)
    ap.add_argument("--exact_match", action="store_true",
                    help="stage 2 matches by the exact LAP on the host")
    ap.add_argument("--seed", type=int, default=0,
                    help="offset of the weight seeds and the shuffles (0: the recipe's)")
    ap.add_argument("--clip_max_norm", type=float, default=0.1,
                    help="stage 2's gradient clip (0.1: the recipe's)")
    ap.add_argument("--out", default="", help="working directory (default: a temp dir)")
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    from synth import make_fscd147

    work = a.out or tempfile.mkdtemp(prefix="torch_convergence_")
    root = make_fscd147(os.path.join(work, "data"), **TREE)
    summary = run(root, os.path.join(work, "out"), a.steps1, a.steps2, a.lr2, a.device,
                  a.dtype, a.exact_match, a.seed, a.clip_max_norm)
    return 0 if within_bounds(summary) else 1


if __name__ == "__main__":
    sys.exit(main())

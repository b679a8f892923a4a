"""Env-gated learning-loop checks of the PyTorch port (RUN_CONVERGENCE=1),
beside tests/test_convergence.py.

- ``test_two_stage_pipeline_converges_on_the_port``: the two-stage pipeline
  trained on synthetic data (tests/torch_convergence_run.py, the JAX
  recipe) must detect on the held-out test split, to the JAX package's
  bounds. It runs on the card in bfloat16 and takes about three minutes on
  an H100; chip_smoke.py's ``convergence`` phase runs the same check.
- ``test_port_follows_jax_through_the_recipe``: stage 2 of the recipe
  trained by the JAX package on the CPU, through the loss plateau and its
  break; at every 100th step the port, from JAX's weights of that step on
  that step's batch, must give the same loss parts and the same gradient.
  About 16 minutes on a CPU.
"""

import json
import os

import numpy as np
import pytest

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(os.environ.get("RUN_CONVERGENCE") != "1",
                       reason="set RUN_CONVERGENCE=1 (3 min on an H100, 16 min on a CPU)"),
]

TRAJECTORY_STEPS = 1500
CHECK_EVERY = 100
PARTS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance")
GRAD_RTOL, GRAD_FLOOR = 1e-2, 1e-9


def test_two_stage_pipeline_converges_on_the_port(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("runs on the card")
    from synth import make_fscd147
    from torch_convergence_run import BOUNDS, TREE, run

    root = make_fscd147(str(tmp_path / "data"), **TREE)
    summary = run(root, str(tmp_path / "out"), steps1=300, steps2=1500, lr2=1e-3,
                  device="cuda", dtype="bfloat16")
    # the JAX package's held-out bounds (tests/test_convergence.py)
    assert summary["test"]["AP50"] > BOUNDS["test_AP50_above"], summary
    assert summary["test"]["MAE@0.5"] < BOUNDS["test_MAE@0.5_below"], summary
    assert summary["train"]["AP50"] > BOUNDS["train_AP50_above"], summary


def gt_pseudo_labels(root: str) -> str:
    """instances_train.json's boxes as a cxcywh pseudo-label file: stage 2
    on the labels of a perfect stage 1."""
    with open(os.path.join(root, "instances_train.json")) as f:
        gt = json.load(f)
    anns = [dict(a, bbox=[a["bbox"][0] + a["bbox"][2] / 2, a["bbox"][1] + a["bbox"][3] / 2,
                          a["bbox"][2], a["bbox"][3]]) for a in gt["annotations"]]
    path = os.path.join(root, "annotations", "pseudo_bbox_train.json")
    with open(path, "w") as f:
        json.dump({"images": gt["images"], "annotations": anns, "box_format": "cxcywh",
                   "categories": gt.get("categories", [])}, f)
    return path


def test_port_follows_jax_through_the_recipe(tmp_path):
    """The recipe's stage 2 (2+2 layers, hidden 64, 25 grid queries, lr 1e-3,
    batch 3 of 96x128) in the JAX package, float32 at 'highest' matmul
    precision, both sides matched by the exact LAP (the optimum of a
    generic cost is unique, where the eps-auction may pick another
    eps-optimal assignment on float noise). At step 0 and every 100th step
    the port's loss parts equal JAX's within rtol 2e-4 (the step-0
    tolerance of tests/test_torch_train.py) and its gradient equals
    ``jax.grad``'s on every trained leaf to an L2 error of 1e-2 of the
    leaf's norm plus 1e-9 of the whole gradient's (float32 through a
    ResNet-50 and two frameworks' reduction orders: at step 1 a backbone
    conv reads 3e-3 of its norm, and the position MLP's near-zero gradient,
    1.4e-6 against a whole of 64, cancels to 1e-2 of its own, 2e-10 of the
    whole; a missing or wrong term reads O(1): a port that detaches the
    position MLP reads 78-87 times the allowance). The optimizer's update
    rule is held separately (tests/test_torch_train.py,
    tests/test_torch_aux_loss.py), so equal gradients along JAX's
    trajectory leave the two packages only float noise apart at every
    step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_default_matmul_precision", "highest")
    from countdetr_tpu import config as jcfg
    from countdetr_tpu.data.batching import Batcher
    from countdetr_tpu.data.fscd147 import FSC147Pseudo
    from countdetr_tpu.models import CountingDetr
    from countdetr_tpu.train.optimizer import _label as jax_label
    from countdetr_tpu.train.optimizer import build_optimizer
    from countdetr_tpu.train.train_step import create_state, make_train_step
    from countdetr_tpu.train.train_step import stage2_loss as jax_stage2_loss
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.train.train_step import prepare_stage2_batch, stage2_loss
    from countdetr_tpu_torch.weights import params_from_jax
    from synth import make_fscd147
    from test_torch_train import leaves_by_name, port_as_jax
    from torch_convergence_run import B, BUCKETS, DIMS, TREE

    root = make_fscd147(str(tmp_path / "data"), **TREE)
    pseudo = gt_pseudo_labels(root)
    dims = dict(DIMS, num_query_position=25)
    cfg = jcfg.stage2_config()
    cfg = cfg.replace(model=cfg.model.replace(**dims),
                      train=cfg.train.replace(lr=1e-3, lr_drop=10**6, exact_match=True))
    jmodel = CountingDetr(cfg.model)
    H, W = BUCKETS[0]
    params = jmodel.init(jax.random.PRNGKey(1), np.zeros((B, H, W, 3), np.float32),
                         np.zeros((B, H, W), bool),
                         exemplar_boxes=np.tile(np.float32([[0.1, 0.1, 0.3, 0.3]]), (B, 3, 1)))
    tx = build_optimizer(cfg.train, params, steps_per_epoch=10**6)
    state, jstep = create_state(params, tx), make_train_step(jmodel, tx, cfg)
    trained = {k for k, v in leaves_by_name(jax.tree_util.tree_map_with_path(
        lambda p, _: jax_label(p) != "frozen", params)).items() if v}
    jgrad = jax.jit(jax.grad(lambda p, x: jax_stage2_loss(jmodel, p, x, cfg), has_aux=True))
    tcfg = stage2_config(**dims)
    batcher = Batcher(FSC147Pseudo(root, "train", pseudo_file=pseudo), B, BUCKETS,
                      max_boxes=36, shuffle=True)

    def check(step, batch):
        """The port against JAX at JAX's weights before this step; returns
        what disagrees."""
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["labels"] = jnp.zeros(batch["boxes"].shape[:2], jnp.int32)
        grads, want_parts = jgrad(state.params, jb)
        want = leaves_by_name(grads)
        model = build_model(tcfg, device="cpu", state_dict=params_from_jax(state.params))
        total, got_parts, _ = stage2_loss(model, prepare_stage2_batch(batch, "cpu"),
                                          TrainConfig(exact_match=True))
        total.backward()
        got_parts = {k: float(got_parts[k].detach()) for k in PARTS}
        want_parts = {k: float(want_parts[k]) for k in PARTS}
        bad = [(k, got_parts[k], want_parts[k]) for k in PARTS
               if not np.isclose(got_parts[k], want_parts[k], rtol=2e-4, atol=0)]
        with torch.no_grad():
            for p in model.parameters():  # the gradients in the weights' places
                p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        got = port_as_jax(model, state.params)
        norm = float(np.sqrt(sum(np.sum(np.square(want[k])) for k in trained)))
        err = {k: float(np.linalg.norm(got[k] - want[k])) for k in trained}
        # the error over what the leaf allows: GRAD_RTOL of its own norm
        # plus GRAD_FLOOR of the whole gradient's
        share = {k: err[k] / (GRAD_RTOL * np.linalg.norm(want[k]) + GRAD_FLOOR * norm)
                 for k in trained}
        worst = max(share, key=share.get)
        print(step, {k: (round(got_parts[k], 5), round(want_parts[k], 5))
                     for k in ("loss", "loss_ce", "loss_giou")},
              "gradient norm", round(norm, 5), "worst leaf", worst,
              "err", err[worst], "of", float(np.linalg.norm(want[worst])), flush=True)
        bad += [(k, err[k], share[k]) for k in trained if share[k] > 1]
        return bad

    done, losses, bad = 0, [], []
    while done < TRAJECTORY_STEPS:
        for batch in batcher:
            batch.pop("meta"), batch.pop("bucket")
            if done % CHECK_EVERY == 0 or done == TRAJECTORY_STEPS - 1:
                bad += [(done, *b) for b in check(done, batch)]
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
            done += 1
            if done >= TRAJECTORY_STEPS:
                break
    assert not bad, bad
    # the trajectory went through the plateau's break: the last 100 steps'
    # mean loss is below the first 500's
    assert np.mean(losses[-100:]) < np.mean(losses[:500]), losses

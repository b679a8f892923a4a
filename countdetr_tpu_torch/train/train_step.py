"""The stage-2 train step (countdetr_tpu/train/train_step.py; reference
2nd-stage engine.py:14-67).

    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.train.train_step import Trainer
    trainer = Trainer(stage2_config(compute_dtype="bfloat16"), TrainConfig())
    metrics = trainer.step(batch)  # 0-d tensors on the card

A step is forward, matching on the device (the auction kernel, on detached
outputs), the stage-2 losses, backward (through the RCDA and MHA kernels'
autograd Functions), clipping, the optimizer update and the LR schedule.
Nothing in it waits for the card, so steps queue back to back; the
non-finite-loss count ``bad_steps`` stays on the device too.

Batches are dicts in the Batcher's format (numpy or tensors): ``images``
s2d-packed uint8 (B, H/2, W/2, 12), ``pad_mask`` (B, H, W) bool,
``exemplar_boxes`` (B, K, 4) xyxy, ``boxes`` (B, T, 4) cxcywh,
``boxes_valid`` (B, T) bool, optional ``labels`` (B, T) (default 0) and
``batch_valid`` (B,) bool.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig, TrainConfig
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.ops import losses as loss_ops
from countdetr_tpu_torch.ops import matching
from countdetr_tpu_torch.ops.losses import MatchedTargets
from countdetr_tpu_torch.train.optimizer import (
    build_optimizer, build_scheduler, clip_gradients, trainable_parameters,
)

BATCH_KEYS = ("images", "pad_mask", "exemplar_boxes", "boxes", "boxes_valid",
              "labels", "batch_valid")


def prepare_stage2_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The batch's tensors on ``device``, with ``labels`` defaulting to 0."""
    out = {}
    for key in BATCH_KEYS:
        if batch.get(key) is None:
            continue
        x = batch[key]
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        out[key] = x.to(device, non_blocking=True)
    if "labels" not in out:
        out["labels"] = torch.zeros(out["boxes"].shape[:2], dtype=torch.long, device=device)
    return out


def match_outputs(pred_logits, pred_boxes, batch, train_cfg: TrainConfig) -> MatchedTargets:
    """Match detached predictions to the batch's targets."""
    with torch.no_grad():
        cost = loss_ops.stage2_cost_matrix(
            pred_logits.detach(), pred_boxes.detach(), batch["boxes"], batch["labels"],
            cost_class=train_cfg.set_cost_class, cost_bbox=train_cfg.set_cost_bbox,
            cost_giou=train_cfg.set_cost_giou,
        )
        solve = matching.exact_batched_match if train_cfg.exact_match else matching.batched_match
        tgt2query, matched = solve(cost, batch["boxes_valid"])
    return MatchedTargets(tgt2query, batch["boxes_valid"], matched)


def stage2_loss(model, batch: Dict[str, torch.Tensor], train_cfg: TrainConfig,
                match: Optional[MatchedTargets] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], MatchedTargets]:
    """Weighted stage-2 loss of a prepared batch (no auxiliary losses).
    Returns (total, the unweighted parts with ``loss``, the match used);
    ``match`` replaces the matcher when given."""
    out = model(batch["images"], batch["pad_mask"], batch["exemplar_boxes"])
    if match is None:
        match = match_outputs(out["pred_logits"], out["pred_boxes"], batch, train_cfg)
    parts = loss_ops.stage2_criterion(
        out["pred_logits"], out["pred_boxes"], out["pred_vars"], batch["boxes"],
        batch["labels"], match, focal_alpha=train_cfg.focal_alpha,
        batch_valid=batch.get("batch_valid"),
    )
    t = train_cfg
    total = (t.cls_loss_coef * parts["loss_ce"] + t.bbox_loss_coef * parts["loss_bbox"]
             + t.giou_loss_coef * parts["loss_giou"]
             + t.variance_loss_coef * parts["loss_variance"])
    parts["loss"] = total
    return total, parts, match


class Trainer:
    """Holds the model (in train mode), the optimizer, the per-step LR
    schedule and the device-side ``bad_steps`` count. Weights come from
    ``state_dict`` or, without one, from ``seed``."""

    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig, device="cuda", seed: int = 0,
                 state_dict: Optional[dict] = None, steps_per_epoch: int = 1):
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.model = build_model(cfg, device=device, seed=seed, state_dict=state_dict).train()
        self.device = next(self.model.parameters()).device
        self.params = trainable_parameters(self.model)
        self.optimizer = build_optimizer(self.model, train_cfg)
        self.scheduler = build_scheduler(self.optimizer, train_cfg, steps_per_epoch)
        self.bad_steps = torch.zeros((), dtype=torch.int32, device=self.device)

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update; returns the losses, ``loss`` and ``grad_norm`` (the
        trainable parameters' gradient norm before clipping) as 0-d tensors
        on the device."""
        batch = prepare_stage2_batch(batch, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics, _ = stage2_loss(self.model, batch, self.train_cfg)
        total.backward()
        metrics["grad_norm"] = clip_gradients(self.params, self.train_cfg.clip_max_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.bad_steps += (~torch.isfinite(total)).int()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The losses of a batch, without an update."""
        batch = prepare_stage2_batch(batch, self.device)
        _, metrics, _ = stage2_loss(self.model, batch, self.train_cfg)
        return metrics

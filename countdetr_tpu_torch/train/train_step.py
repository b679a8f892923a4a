"""The train steps of both stages (countdetr_tpu/train/train_step.py;
reference 1st-stage engine.py:27-75, 2nd-stage engine.py:14-67).

    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.train.train_step import Trainer
    trainer = Trainer(stage2_config(compute_dtype="bfloat16"), TrainConfig())
    metrics = trainer.step(batch)  # 0-d tensors on the card

``cfg.stage`` picks the loss. Stage 1 (``stage1_config``): the forward on
the exemplar centres as queries and the wh losses against their w, h; no
matching. Neither loss reads masks (as in the JAX package), so the forward
skips the mask head of a ``masks`` model: its parameters get zero
gradients and only the weight decay moves them, as in the JAX package.
Stage 2: the forward, matching on the device (the auction kernel,
on detached outputs) and the stage-2 losses; with ``aux_loss`` each earlier
decoder layer is matched on its own (one more auction launch each, as the
JAX package matches each output) and its weighted class, L1 and GIoU terms
are added. Then backward (through the RCDA and MHA kernels' autograd
Functions), clipping, the optimizer update and the LR schedule. Nothing in
a step waits for the card, so steps queue back to back; the
non-finite-loss count ``bad_steps`` stays on the device too.

With ``dropout > 0`` a step draws its masks from a generator seeded by
(``TrainConfig.seed ^ 0x5EED``, the step), the counterpart of the JAX
package's ``fold_in(PRNGKey(seed ^ 0x5EED), step)``: a resumed run draws
the same masks, and a checkpoint carries no generator state. Under data
parallelism the data index is a third part of the seed, so the data ranks
draw different masks, and the model ranks of one data index the same.

Data parallelism (``Trainer(..., distributed=True)`` in a process group,
core/mesh.py): the model and its loss are one module (``StageLoss``) in
DistributedDataParallel, with ``find_unused_parameters`` (the stage-1 cls
head and a mask head get no gradient). Each rank feeds its slice of the
global batch; the losses' normalisers are global (ops/losses.py), so each
rank's loss is its share of the global loss, and the backward runs on the
share times the world size, so that DDP's averaged gradient is the
global loss's gradient. The step's metrics are the global values (the
shares summed), equal on every rank, and so is ``bad_steps``: every rank
takes the same decision on a non-finite loss.

Tensor parallelism (``TrainConfig(mesh_shape=(D, M), mesh_axes=("data",
"model"))``, distributed, a world of D * M): the Trainer builds the full
model (from ``seed`` or ``state_dict``) and keeps its model rank's shard
(core/tensor_parallel.py). The M ranks of a data index feed the same rows
(the Batcher's stride is ``mesh.data_index()`` of ``mesh.data_count()``)
and run the replicated parts, the matcher on their bit-equal copies of the
outputs included, alike. DDP, ``GlobalSum`` and the loss scale span the
data group only (no DDP at D = 1); the replicated parameters' gradients
are averaged over the model group (``average_replicated_grads``: the card's
backward is not bit-reproducible), and the clip takes the norm over shards
and replicas. ``state_dict`` gathers the full weights and AdamW moments over
the model group, and ``load_state_dict`` takes full ones and shards them,
so a checkpoint of any mesh loads on any other.

Batches are dicts in the Batcher's format (numpy or tensors): ``images``
s2d-packed uint8 (B, H/2, W/2, 12), ``pad_mask`` (B, H, W) bool, optional
``batch_valid`` (B,) bool, and
  stage 1: ``points`` (B, P, 2) cx, cy, ``points_valid`` (B, P) bool,
    ``whs`` (B, P, 2);
  stage 2: ``exemplar_boxes`` (B, K, 4) xyxy, ``boxes`` (B, T, 4) cxcywh,
    ``boxes_valid`` (B, T) bool, optional ``labels`` (B, T) (default 0),
    and under the sampled prior ``sampled_points`` (B, S, 2),
    ``sampled_points_valid`` (B, S).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig, TrainConfig
from countdetr_tpu_torch.core import mesh, tensor_parallel
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.ops import losses as loss_ops
from countdetr_tpu_torch.ops import matching
from countdetr_tpu_torch.ops.losses import MatchedTargets
from countdetr_tpu_torch.train.optimizer import (
    build_optimizer, build_scheduler, clip_gradients, trainable_parameters,
)

BATCH_KEYS = ("images", "pad_mask", "exemplar_boxes", "boxes", "boxes_valid",
              "labels", "batch_valid", "sampled_points", "sampled_points_valid")
DROPOUT_SEED_XOR = 0x5EED
STAGE1_BATCH_KEYS = ("images", "pad_mask", "points", "points_valid", "whs", "batch_valid")


def _to_device(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    out = {}
    for key in keys:
        if batch.get(key) is None:
            continue
        x = batch[key]
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        out[key] = x.to(device, non_blocking=True)
    return out


def prepare_stage1_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The stage-1 batch's tensors on ``device``."""
    return _to_device(batch, STAGE1_BATCH_KEYS, device)


def prepare_stage2_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The batch's tensors on ``device``, with ``labels`` defaulting to 0."""
    out = _to_device(batch, BATCH_KEYS, device)
    if "labels" not in out:
        out["labels"] = torch.zeros(out["boxes"].shape[:2], dtype=torch.long, device=device)
    return out


def dropout_generator(seed: int, step: int, device, rank: Optional[int] = None
                      ) -> torch.Generator:
    """The dropout masks' generator of optimizer step ``step``: seeded from
    (seed ^ 0x5EED, step), and ``rank`` when given, through numpy's
    SeedSequence, on ``device``."""
    entropy = [seed ^ DROPOUT_SEED_XOR, step] + ([] if rank is None else [rank])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))


def stage1_loss(model, batch: Dict[str, torch.Tensor], train_cfg: TrainConfig,
                generator: Optional[torch.Generator] = None, reduce=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted stage-1 loss of a prepared batch: (total, the unweighted
    parts with ``loss``); with ``reduce`` (a core.mesh.GlobalSum) this
    rank's shares of the global batch's values."""
    out = model(batch["images"], batch["pad_mask"], batch["points"], batch["points_valid"],
                generator=generator, masks=False)
    parts = loss_ops.stage1_criterion(out["pred_wh"], batch["points"], batch["whs"],
                                      batch["points_valid"], reduce=reduce)
    total = (train_cfg.wh_loss_coef * parts["loss_wh"]
             + train_cfg.stage1_giou_coef * parts["loss_giou"])
    parts["loss"] = total
    return total, parts


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
                match: Optional[MatchedTargets] = None,
                generator: Optional[torch.Generator] = None, reduce=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], MatchedTargets]:
    """Weighted stage-2 loss of a prepared batch. Returns (total, the
    unweighted parts with ``loss``, the last layer's match); ``match``
    replaces the matcher of the last layer when given. The batch's
    ``sampled_points`` are the sampled prior's anchors. With auxiliary
    outputs (``aux_loss``), each is matched on its own and adds its class,
    L1 and GIoU terms, with variances of ones (the variance head is read
    on the last layer only), as ``loss_ce_{i}``, ``loss_bbox_{i}``,
    ``loss_giou_{i}`` (reference SetCriterion, 2nd-stage
    anchor_detr.py:334-347). With ``reduce`` (a core.mesh.GlobalSum) the
    values are this rank's shares of the global batch's."""
    out = model(batch["images"], batch["pad_mask"], batch["exemplar_boxes"],
                batch.get("sampled_points"), batch.get("sampled_points_valid"),
                generator=generator, masks=False)
    if match is None:
        match = match_outputs(out["pred_logits"], out["pred_boxes"], batch, train_cfg)
    t = train_cfg

    def criterion(logits, boxes, vars_, m):
        return loss_ops.stage2_criterion(
            logits, boxes, vars_, batch["boxes"], batch["labels"], m,
            focal_alpha=t.focal_alpha, batch_valid=batch.get("batch_valid"), reduce=reduce)

    parts = criterion(out["pred_logits"], out["pred_boxes"], out["pred_vars"], match)
    total = (t.cls_loss_coef * parts["loss_ce"] + t.bbox_loss_coef * parts["loss_bbox"]
             + t.giou_loss_coef * parts["loss_giou"]
             + t.variance_loss_coef * parts["loss_variance"])
    for i, aux in enumerate(out.get("aux_outputs", ())):
        m_i = match_outputs(aux["pred_logits"], aux["pred_boxes"], batch, t)
        p_i = criterion(aux["pred_logits"], aux["pred_boxes"],
                        torch.ones_like(out["pred_vars"]), m_i)
        total = total + (t.cls_loss_coef * p_i["loss_ce"] + t.bbox_loss_coef * p_i["loss_bbox"]
                         + t.giou_loss_coef * p_i["loss_giou"])
        for k in ("loss_ce", "loss_bbox", "loss_giou"):
            parts[f"{k}_{i}"] = p_i[k]
    parts["loss"] = total
    return total, parts, match


class StageLoss(torch.nn.Module):
    """The model and its stage's weighted loss as one module: forward(a
    prepared batch, generator) -> (total, parts). Under data parallelism
    this is the module DDP wraps, so that the outputs DDP traverses for
    unused parameters are the loss and its parts."""

    def __init__(self, model, train_cfg: TrainConfig, reduce=None):
        super().__init__()
        self.model = model
        self.train_cfg = train_cfg
        self.reduce = reduce

    def forward(self, batch: Dict[str, torch.Tensor], generator=None):
        if self.model.cfg.stage == 1:
            return stage1_loss(self.model, batch, self.train_cfg, generator=generator,
                               reduce=self.reduce)
        total, parts, _ = stage2_loss(self.model, batch, self.train_cfg, generator=generator,
                                      reduce=self.reduce)
        return total, parts


class Trainer:
    """Holds the model (in train mode), the optimizer, the per-step LR
    schedule and the device-side ``bad_steps`` count. Weights come from
    ``state_dict`` or, without one, from ``seed``. ``distributed``: train
    over the process group on the mesh of ``train_cfg.mesh_shape`` /
    ``mesh_axes`` (core/mesh.py; see the module's docstring), each data rank
    on its own slice of the global batch, each model rank on its shard of
    the weights; DDP's construction broadcasts the weights of the data
    group's first rank."""

    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig, device="cuda", seed: int = 0,
                 state_dict: Optional[dict] = None, steps_per_epoch: int = 1,
                 distributed: bool = False):
        mesh.check_mesh(train_cfg.mesh_shape, train_cfg.mesh_axes)
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.mesh = (mesh.make_mesh(train_cfg.mesh_shape, train_cfg.mesh_axes) if distributed
                     else None)
        self.tp = self.mesh is not None and self.mesh.model_count() > 1
        self.model = build_model(cfg, device=device, seed=seed, state_dict=state_dict).train()
        if self.tp:
            tensor_parallel.shard_params_tp(self.model, self.mesh)
        self.device = next(self.model.parameters()).device
        self.params = trainable_parameters(self.model)
        self.optimizer = build_optimizer(self.model, train_cfg)
        self.scheduler = build_scheduler(self.optimizer, train_cfg, steps_per_epoch)
        self.bad_steps = torch.zeros((), dtype=torch.int32, device=self.device)
        # data parallelism over the data group: every rank of a data-only
        # mesh (a world of 1 too), the D ranks of a model index under TP
        ddp = distributed and (not self.tp or self.mesh.data_count() > 1)
        self.reduce = mesh.GlobalSum(self.mesh) if ddp else None
        self.world = self.reduce.world if ddp else 1
        self.rank = self.mesh.data_index() if distributed else 0
        self.loss_module = StageLoss(self.model, train_cfg, self.reduce)
        self._forward = (mesh.wrap_ddp(self.loss_module, self.device, self.mesh.data_group)
                         if ddp else self.loss_module)

    def _prepare(self, batch: Dict) -> Dict[str, torch.Tensor]:
        prepare = prepare_stage1_batch if self.cfg.stage == 1 else prepare_stage2_batch
        return prepare(batch, self.device)

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update; returns the losses, ``loss`` and ``grad_norm`` (the
        trainable parameters' gradient norm before clipping) as 0-d tensors
        on the device: the global batch's values under data parallelism."""
        self.optimizer.zero_grad(set_to_none=True)
        g = (dropout_generator(self.train_cfg.seed, self.scheduler.last_epoch, self.device,
                               self.rank if self.world > 1 else None)
             if self.cfg.dropout > 0 else None)
        total, metrics = self._forward(self._prepare(batch), g)
        (total * self.world if self.world > 1 else total).backward()
        if self.reduce is not None:
            metrics = self.reduce.sum_dict(metrics)
        for p in self.params:
            # a tensor the loss does not reach (the cls head in stage 1)
            # still decays, as in the JAX package's optimizer
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.tp:  # the model ranks' replicated copies take the same update
            tensor_parallel.average_replicated_grads(self.params, self.mesh)
        metrics["grad_norm"] = clip_gradients(self.params, self.train_cfg.clip_max_norm,
                                              self.mesh)
        self.optimizer.step()
        self.scheduler.step()
        self.bad_steps += (~torch.isfinite(metrics["loss"])).int()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The losses of a batch, without an update (and without dropout):
        the global batch's under data parallelism."""
        parts = self.loss_module(self._prepare(batch))[1]
        return parts if self.reduce is None else self.reduce.sum_dict(parts)

    def _moments(self, opt_state: Dict, convert) -> Dict:
        """``opt_state`` with ``convert(name, tensor)`` applied to each
        parameter's moments (AdamW's exp_avg and exp_avg_sq, SGD's
        momentum_buffer); the state's ids count the groups' parameters in
        order."""
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        names = [by_id[id(p)] for group in self.optimizer.param_groups for p in group["params"]]
        state = {i: {k: convert(names[i], v) if isinstance(v, torch.Tensor) and v.dim() else v
                     for k, v in s.items()}
                 for i, s in opt_state["state"].items()}
        return {**opt_state, "state": state}

    def state_dict(self) -> Dict:
        """Everything a resumed run needs (train/checkpoints.py): weights and
        buffers, the optimizer's moments and step counts, the scheduler's
        position, ``bad_steps`` and the optimizer step. References to the
        live tensors, not copies, except under tensor parallelism, where the
        weights and moments are gathered over the model group (every model
        rank calls it). The model's own keys, without DDP's ``module.``
        prefix, so a checkpoint of any mesh loads in any other."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.tp:
            layout = tensor_parallel.tp_layout(model, self.mesh.model_count())
            model = tensor_parallel.gather_params_tp(model, self.mesh)
            opt = self._moments(opt, lambda name, v: tensor_parallel.gather_tensor(
                v, *layout[name], self.mesh) if name in layout else v)
        return {"model": model, "optimizer": opt,
                "scheduler": self.scheduler.state_dict(), "bad_steps": self.bad_steps,
                "step": self.scheduler.last_epoch}

    def load_state_dict(self, state: Dict):
        """A state of full tensors (``state_dict``'s, or a checkpoint's of
        any mesh); under tensor parallelism cut to this rank's shard."""
        model, opt = state["model"], state["optimizer"]
        if self.tp:
            m, M = self.mesh.model_index(), self.mesh.model_count()
            layout = tensor_parallel.tp_layout(model)
            model = tensor_parallel.shard_state(model, m, M)
            opt = self._moments(opt, lambda name, v: tensor_parallel.shard_tensor(
                v, *layout[name], m, M) if name in layout else v)
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(opt)
        self.scheduler.load_state_dict(state["scheduler"])
        self.bad_steps.copy_(state["bad_steps"])

"""Optimizer, clipping and LR schedule (countdetr_tpu/train/optimizer.py;
reference main.py:149-204, engine.py:55-57).

AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) or SGD with
momentum 0.9, in two groups: the backbone at ``lr_backbone``, the rest at
``lr``. Frozen parameters (the stem, layer1; FrozenBatchNorm tensors are
buffers) have ``requires_grad=False`` and are in no group. The gradient is
clipped to ``clip_max_norm`` over the trainable parameters, torch-style
(max_norm / (norm + 1e-6)); under tensor parallelism the norm is the
global one over the model group's shards and the replicated tensors. The
LR changes per step: StepLR by
``step // steps_per_epoch // lr_drop``, or MultiStepLR over ``lr_drop_epochs``.
"""

from __future__ import annotations

from typing import List

import torch

from countdetr_tpu_torch.config import TrainConfig


def trainable_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def build_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    groups = [
        {"params": [p for n, p in model.named_parameters()
                    if p.requires_grad and "backbone" not in n], "lr": cfg.lr},
        {"params": [p for n, p in model.named_parameters()
                    if p.requires_grad and "backbone" in n], "lr": cfg.lr_backbone},
    ]
    if cfg.sgd:
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=0.9, weight_decay=cfg.weight_decay)
    return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def lr_factor(step: int, cfg: TrainConfig, steps_per_epoch: int) -> float:
    """The LR multiplier at optimizer step ``step`` (0-based)."""
    epoch = step // max(steps_per_epoch, 1)
    if cfg.lr_drop_epochs:
        return 0.1 ** sum(1 for e in cfg.lr_drop_epochs if e <= epoch)
    return 0.1 ** (epoch // cfg.lr_drop)


def build_scheduler(optimizer: torch.optim.Optimizer, cfg: TrainConfig,
                    steps_per_epoch: int) -> torch.optim.lr_scheduler.LambdaLR:
    """Stepped once after every optimizer step."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: lr_factor(step, cfg, steps_per_epoch))


def clip_gradients(params, max_norm: float, mesh=None) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / (norm + 1e-6)); returns the
    global norm before clipping, a 0-d tensor on the gradients' device (no
    host sync). With a ``mesh`` (core/mesh.py::Mesh) of a model axis M > 1,
    the norm is that of the full gradient: the replicated tensors' squared
    norm (the same on every model rank) plus the model group's sum of the
    shards' (the parameters ``shard_params_tp`` marked with ``tp_dim``), one
    0-d all-reduce; every model rank then scales by the same factor."""
    params = [p for p in params if p.grad is not None]
    if mesh is None or mesh.model_count() == 1:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    import torch.distributed as dist

    def sq_norm(ps):
        grads = [p.grad for p in ps]
        if not grads:
            return torch.zeros((), device=params[0].grad.device)
        return torch.nn.utils.get_total_norm(grads).square()

    sharded = [p for p in params if getattr(p, "tp_dim", None) is not None]
    shard_sq = sq_norm(sharded)
    dist.all_reduce(shard_sq, group=mesh.model_group)
    total = (sq_norm([p for p in params if getattr(p, "tp_dim", None) is None])
             + shard_sq).sqrt()
    torch.nn.utils.clip_grads_with_norm_(params, max_norm, total)
    return total

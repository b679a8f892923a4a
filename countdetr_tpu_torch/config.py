"""Configuration of the port: its own copy of the JAX package's
``ModelConfig``, ``TrainConfig`` and ``stage2_config``
(countdetr_tpu/config.py), with the TPU-only knobs (use_pallas_rcda,
param_dtype, remat, the COUNTDETR_* environment switches), the dropout
(0 in every published run) and the checkpoint, logging and mesh fields
left out."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """AnchorDETR-style counting model (reference models/transformer.py:20-97,
    models/anchor_detr.py:34-140 for stage 2)."""

    # backbone: ResNet-50; DC5 gives stride-16 C5 features
    backbone: str = "resnet50"
    dilation: bool = True
    num_feature_levels: int = 1

    # transformer
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    activation: str = "relu"
    attention_type: str = "RCDA"

    # queries
    num_query_position: int = 300
    num_query_pattern: int = 3
    spatial_prior: str = "learned"  # learned | grid | defined | sampled

    num_classes: int = 2
    masks: bool = False

    # stage switches
    stage: int = 1
    with_variance_head: bool = False
    exemplar_aggregation: bool = False
    aux_loss: bool = False

    # parameters are float32; activations run in compute_dtype
    compute_dtype: str = "float32"

    @property
    def num_queries(self) -> int:
        if self.spatial_prior == "grid":
            n = round(math.sqrt(self.num_query_position))
            return n * n * self.num_query_pattern
        return self.num_query_position * self.num_query_pattern

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization, the reference's defaults (main.py:29-45, 96-121)."""

    lr: float = 1e-4
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    lr_drop: int = 20  # StepLR: lr *= 0.1 every lr_drop epochs
    # MultiStepLR drop epochs; overrides lr_drop when set (reference
    # 2nd-stage main.py:39 --lr_drop_epochs)
    lr_drop_epochs: Optional[Tuple[int, ...]] = None
    clip_max_norm: float = 0.1
    sgd: bool = False

    # loss coefficients
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    variance_loss_coef: float = 2.0
    focal_alpha: float = 0.25

    # matcher costs
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    # exact LAP on the host (scipy, as the reference matches) instead of
    # the on-device auction
    exact_match: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def stage2_config(**model_kw) -> ModelConfig:
    """Stage-2 uncertainty-aware detector: grid prior of 600 positions (576
    queries), one pattern, variance head, exemplar feature aggregation
    (reference scripts/var_wh_laplace_600.sh). Keywords override any field."""
    return ModelConfig(
        stage=2,
        spatial_prior="grid",
        num_query_pattern=1,
        num_query_position=600,
        with_variance_head=True,
        exemplar_aggregation=True,
        aux_loss=False,
    ).replace(**model_kw)

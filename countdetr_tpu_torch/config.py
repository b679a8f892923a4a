"""Configuration of the port: its own copy of the JAX package's
``ModelConfig``, ``DataConfig``, ``TrainConfig``, ``Config``,
``stage1_config`` and ``stage2_config`` (countdetr_tpu/config.py).

Left out: the TPU-only knobs (use_pallas_rcda, param_dtype and the
COUNTDETR_* environment switches other than the RCDA variant).
``TrainConfig.mesh_shape``/``mesh_axes`` take only the data axis over the
processes (core/mesh.py): tensor parallelism, a "model" axis, is not
ported (ROADMAP.md Queue 1)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

RCDA_VARIANTS = ("v3", "rank1")
ATTENTION_TYPES = ("RCDA", "MHA")


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
    dropout: float = 0.0
    activation: str = "relu"
    attention_type: str = "RCDA"  # "RCDA" | "MHA" (standard attention)

    # queries
    num_query_position: int = 300
    num_query_pattern: int = 3
    spatial_prior: str = "learned"  # learned | grid | defined | sampled

    num_classes: int = 2
    masks: bool = False  # the mask head (DETRsegm's, models/segmentation.py)

    # stage switches
    stage: int = 1
    with_variance_head: bool = False
    exemplar_aggregation: bool = False
    aux_loss: bool = False

    # parameters are float32; activations run in compute_dtype
    compute_dtype: str = "float32"

    # RCDA core on the card: "v3" the two-stage combine (csrc/rcda.cu),
    # "rank1" one H*W contraction of the rank-1 probabilities
    # (csrc/rcda_rank1.cu). The counterpart of the JAX package's
    # COUNTDETR_PALLAS_VARIANT (countdetr_tpu/ops/rcda.py), same values.
    rcda_variant: str = "v3"
    # recompute each encoder and decoder layer's activations in the backward
    # instead of keeping them (torch.utils.checkpoint; the JAX package's
    # nn.remat): less memory, one more forward of those layers
    remat: bool = False

    def __post_init__(self):
        if self.rcda_variant not in RCDA_VARIANTS:
            raise ValueError(f"rcda_variant must be one of {RCDA_VARIANTS}, "
                             f"got {self.rcda_variant!r}")
        if self.attention_type not in ATTENTION_TYPES:
            raise ValueError(f"attention_type must be one of {ATTENTION_TYPES}, "
                             f"got {self.attention_type!r}")

    def check_options(self):
        """ValueError for a combination of model options the JAX model
        cannot build (countdetr_tpu/models/anchor_detr.py:199-201, :274;
        countdetr_tpu/models/transformer.py:384-386, :412-425). The model
        checks its config; a config alone may hold any combination (the
        CLI's --evaluate_predictions reads no model)."""
        levels = self.num_feature_levels
        if levels not in (1, 3):
            raise ValueError(f"num_feature_levels must be 1 or 3 (the backbone gives "
                             f"C3, C4, C5), got {levels}")
        if levels > 1:
            if self.exemplar_aggregation:
                raise ValueError("num_feature_levels > 1 excludes exemplar aggregation "
                                 "(defined on the single C5 level: stage 2)")
            if self.masks:
                raise ValueError("masks exclude num_feature_levels > 1 (the mask head "
                                 "reads one level)")
            if self.attention_type != "RCDA":
                raise ValueError("num_feature_levels > 1 takes RCDA attention only (the JAX "
                                 "transformer's 2-D position embedding is per image, not "
                                 "per level)")
            if not self.dilation:
                raise ValueError("num_feature_levels > 1 needs the dilated C5 (DC5): "
                                 "C3, C4 and C5 meet at stride 16")

    @property
    def num_queries(self) -> int:
        if self.spatial_prior == "grid":
            n = round(math.sqrt(self.num_query_position))
            return n * n * self.num_query_pattern
        return self.num_query_position * self.num_query_pattern

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset and fixed-shape batching: images resized to scale_factor
    multiples and padded into a few (H, W) buckets with a padding mask;
    points and boxes padded to capacities with validity masks."""

    dataset: str = "fscd_147"  # fscd_147 | fscd_lvis
    data_path: str = ""
    scale_factor: int = 32
    batch_size: int = 8
    num_workers: int = 2
    cache_mode: bool = False  # raw image bytes in RAM (reference --cache_mode)
    decoded_cache: bool = False  # resized uint8 in RAM; overrides cache_mode
    # resized uint8 in .npz blobs shared by workers and runs (data/cache.py);
    # overrides decoded_cache and cache_mode
    decoded_cache_dir: str = ""
    # True: readers emit ImageNet-normalized float32; False (the CLI's
    # default): raw resized uint8, normalized by the model on the device
    host_normalize: bool = True
    # space-to-depth pack batches on the host (B, H/2, W/2, 12); the CLI
    # turns it on for the raw uint8 pipe
    pack_s2d: bool = False
    # points the FSCD-147 readers draw from the density map for the sampled
    # prior (0: none; the CLI sets --num_sample_points under that prior)
    num_sampled_points: int = 0
    max_points: int = 700
    max_boxes: int = 700
    max_exemplars: int = 3
    buckets: Tuple[Tuple[int, int], ...] = ((384, 384), (384, 512), (384, 672))

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization, the reference's defaults (main.py:29-45, 96-121), and
    the run: schedule length, seed, checkpoints and logging."""

    lr: float = 1e-4
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    epochs: int = 30
    max_steps: int = 0  # a cap on the run's train steps (0: none)
    lr_drop: int = 20  # StepLR: lr *= 0.1 every lr_drop epochs
    # MultiStepLR drop epochs; overrides lr_drop when set (reference
    # 2nd-stage main.py:39 --lr_drop_epochs)
    lr_drop_epochs: Optional[Tuple[int, ...]] = None
    clip_max_norm: float = 0.1
    sgd: bool = False
    seed: int = 42

    # loss coefficients
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    variance_loss_coef: float = 2.0
    wh_loss_coef: float = 1.0  # stage-1 BoundingBoxCriterion weights
    stage1_giou_coef: float = 0.4
    focal_alpha: float = 0.25

    # matcher costs
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    # exact LAP on the host (scipy, as the reference matches) instead of
    # the on-device auction
    exact_match: bool = False

    # checkpoints (train/checkpoints.py) and logging
    output_dir: str = ""
    resume: str = ""
    auto_resume: bool = False
    checkpoint_every: int = 1  # epochs
    # retention (gc_checkpoints): the keep_last newest, every keep_every-th
    # epoch and the lr-drop epochs; keep_last <= 0 keeps everything
    checkpoint_keep_last: int = 1
    checkpoint_keep_every: int = 10
    async_checkpoint: bool = True  # AsyncSaver; False blocks on each save
    log_every: int = 100  # steps

    # parallelism: one "data" axis over the processes (-1: all of them);
    # core/mesh.py::check_mesh refuses anything else
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def stage1_config(**model_kw) -> ModelConfig:
    """Stage-1 pseudo-GT regressor: the annotated points are the queries
    (the defined prior), one pattern, no variance head, no exemplar
    aggregation (reference scripts/weakly_supervise_fscd_147.sh). Keywords
    override any field."""
    return ModelConfig(
        stage=1,
        spatial_prior="defined",
        num_query_pattern=1,
        num_query_position=3,
        with_variance_head=False,
        exemplar_aggregation=False,
    ).replace(**model_kw)


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

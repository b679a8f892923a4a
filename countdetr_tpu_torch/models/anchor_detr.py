"""CountingDetr, stage 2 (countdetr_tpu/models/anchor_detr.py; reference
2nd-stage models/anchor_detr.py:34-140, backbone.py:116-145).

backbone C5 -> exemplar feature aggregation (the feature at each exemplar
box's centre, averaged, modulates the map channel-wise; concat -> 4096 ch)
-> 1x1 aggr_input_proj + masked GroupNorm(32) -> transformer with the grid
prior and the Laplace variance head. Outputs {pred_logits, pred_boxes,
pred_vars, reference_points}, float32.

Module names follow the reference torch model (``backbone.body.*``,
``aggr_input_proj.0.{0,1}.*``, ``transformer.*``), so a state_dict maps to
and from the JAX package's params by name (weights.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.models.resnet import (
    Conv, ResNetBackbone, StemConv, downsample_mask,
)
from countdetr_tpu_torch.models.transformer import Transformer, init_transformer_
from countdetr_tpu_torch.ops.posemb import grid_reference_points

IMNET_MEAN = (0.485, 0.456, 0.406)
IMNET_STD = (0.229, 0.224, 0.225)


def resolve_device(device) -> torch.device:
    """The requested device; CUDA that is not there raises, never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize raw uint8 images in float32; 3-channel or the
    12-channel space-to-depth form (the constants tile)."""
    reps = images.shape[-1] // 3
    mean = torch.tensor(IMNET_MEAN, dtype=torch.float32, device=images.device).repeat(reps)
    std = torch.tensor(IMNET_STD, dtype=torch.float32, device=images.device).repeat(reps)
    return (images.float() / 255.0 - mean) / std


def pack_mask_s2d(pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H/2, W/2, 12) in pack_space_to_depth's channel
    order ((a*2+b)*3 + c), to re-zero padded pixels of a packed image."""
    B, H, W = pad_mask.shape
    m4 = pad_mask.reshape(B, H // 2, 2, W // 2, 2).permute(0, 1, 3, 2, 4)
    return m4.reshape(B, H // 2, W // 2, 4).repeat_interleave(3, dim=-1)


class MaskedGroupNorm(nn.Module):
    """GroupNorm(32) whose float32 statistics see only valid pixels; with no
    padding it is torch's GroupNorm. x is NHWC."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        B, H, W, C = x.shape
        G = self.num_groups
        xg = x.reshape(B, H, W, G, C // G).float()
        if valid is None:
            mean = xg.mean(dim=(1, 2, 4), keepdim=True)
            var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        else:
            v = valid[..., None, None].float()  # (B, H, W, 1, 1)
            n = v.sum(dim=(1, 2, 3, 4), keepdim=True).clamp(min=1.0) * (C // G)
            mean = (xg * v).sum(dim=(1, 2, 4), keepdim=True) / n
            var = ((xg - mean).square() * v).sum(dim=(1, 2, 4), keepdim=True) / n
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        out = xg.reshape(B, H, W, C) * self.weight + self.bias
        return out.to(x.dtype)


class InputProj(nn.Sequential):
    """1x1 conv + masked GroupNorm(32) (reference anchor_detr.py:49-73),
    as the reference's Sequential(conv, norm). NHWC in; the conv runs in
    float32 (the JAX package promotes it to its float32 parameters)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 1), MaskedGroupNorm(cout))

    def forward(self, x, valid=None):
        conv, norm = self[0], self[1]
        x = F.linear(x.float(), conv.weight.flatten(1), conv.bias)
        return norm(x, valid)


def exemplar_aggregate(feat: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """feat (B, h, w, C), rects (B, K, 4) normalized xyxy -> (B, h, w, 2C):
    the feature at each box centre pixel (int() truncation of
    (x0 + x1) / 2 * w in float32, then clipped), averaged over exemplars,
    modulates the map; concat [feat, feat * vec]."""
    B, h, w, C = feat.shape
    rects = rects.float()
    cx = (rects[..., 0] + rects[..., 2]) * 0.5 * w
    cy = (rects[..., 1] + rects[..., 3]) * 0.5 * h
    xi = cx.to(torch.int32).clamp(0, w - 1).long()
    yi = cy.to(torch.int32).clamp(0, h - 1).long()
    bidx = torch.arange(B, device=feat.device)[:, None]
    vec = feat[bidx, yi, xi].mean(dim=1)  # (B, C)
    return torch.cat([feat, feat * vec[:, None, None, :]], dim=-1)


class CountingDetr(nn.Module):
    """The stage-2 counting detector.

    forward(images, pad_mask, exemplar_boxes):
      images (B, H, W, 3) or s2d-packed (B, H/2, W/2, 12), raw uint8 or
        normalized float;
      pad_mask (B, H, W) bool, True on padding;
      exemplar_boxes (B, K, 4) normalized xyxy.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        unsupported = []
        if cfg.stage != 2 or not (cfg.exemplar_aggregation and cfg.with_variance_head):
            unsupported.append("stage 2 with exemplar aggregation and the variance head")
        if cfg.spatial_prior != "grid":
            unsupported.append("the grid spatial prior")
        if cfg.num_feature_levels != 1 or cfg.masks or cfg.attention_type != "RCDA":
            unsupported.append("one feature level, RCDA attention, no mask head")
        if cfg.aux_loss or cfg.backbone != "resnet50" or cfg.activation != "relu":
            unsupported.append("ResNet-50, relu, no auxiliary outputs")
        if unsupported:
            raise NotImplementedError("the port supports only " + "; ".join(unsupported))
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.backbone = nn.ModuleDict(
            {"body": ResNetBackbone(dilation=cfg.dilation, compute_dtype=dt)})
        self.aggr_input_proj = nn.ModuleList([InputProj(2 * 2048, cfg.hidden_dim)])
        self.transformer = Transformer(cfg)

    def forward(self, images, pad_mask, exemplar_boxes):
        if images.dtype == torch.uint8:
            images = normalize_uint8(images)
            # raw pads are 0, which normalizes to -mean/std: re-zero them so
            # the stem sees the same zeros as the host-normalized pipe
            packed = images.shape[-1] == 12
            pm = pack_mask_s2d(pad_mask) if packed else pad_mask[..., None]
            images = images.masked_fill(pm, 0.0)
        feat = self.backbone["body"](images, pad_mask)
        h, w = feat.shape[1], feat.shape[2]
        fmask = downsample_mask(pad_mask, h, w)
        feat = exemplar_aggregate(feat, exemplar_boxes)
        src = self.aggr_input_proj[0](feat, ~fmask)
        B = images.shape[0]
        pos = grid_reference_points(self.cfg.num_query_position, device=images.device)
        ref = pos[None].expand(B, *pos.shape)
        tr = self.transformer(src, fmask, ref)
        return {
            "pred_logits": tr["cls"],
            "pred_boxes": tr["coord"],
            "pred_vars": tr["var"],
            "reference_points": tr["reference_points"],
        }


@torch.no_grad()
def init_weights_(model: CountingDetr, g: torch.Generator):
    """Random initialisation from a seeded generator, following the JAX
    package's initialisers: lecun-normal backbone convs, identity frozen BN,
    xavier-uniform input projection, the transformer's own scheme."""
    for m in model.backbone.modules():
        if isinstance(m, (Conv, StemConv)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in))
    conv = model.aggr_input_proj[0][0]
    cout, cin = conv.weight.shape[:2]
    limit = math.sqrt(6.0 / (cin + cout))
    conv.weight.copy_((torch.rand(conv.weight.shape, generator=g) * 2 - 1) * limit)
    conv.bias.zero_()
    init_transformer_(model.transformer, g)


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                state_dict: Optional[dict] = None) -> CountingDetr:
    """A CountingDetr on ``device`` in eval mode: weights from ``state_dict``
    (loaded strictly) or, without one, random from ``seed``. The model has
    no dropout, so train and eval mode compute the same; a trainer calls
    ``.train()`` all the same."""
    dev = resolve_device(device)
    model = CountingDetr(cfg)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()

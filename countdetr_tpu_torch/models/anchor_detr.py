"""CountingDetr, stages 1 and 2 (countdetr_tpu/models/anchor_detr.py;
reference 1st-stage models/anchor_detr.py:33-113, 2nd-stage
models/anchor_detr.py:34-140, backbone.py:116-145).

Stage 1, the pseudo-GT regressor: backbone C5 -> 1x1 input_proj + masked
GroupNorm(32) -> transformer (stage1_config: the defined prior) ->
{pred_logits, pred_points, pred_wh}, float32.

Stage 2, the detector: backbone C5 -> exemplar feature aggregation (the
feature at each exemplar box's centre, averaged, modulates the map
channel-wise; concat -> 4096 ch) -> 1x1 aggr_input_proj + masked
GroupNorm(32) -> transformer with the Laplace variance head (stage2_config:
the grid prior) -> {pred_logits, pred_boxes, pred_vars, reference_points},
float32, and with ``aux_loss`` the earlier decoder layers' ``aux_outputs``.

The spatial prior gives the reference points, in either stage
(countdetr_tpu/models/anchor_detr.py:220-238): "learned" a parameter of
num_query_position points, "grid" a fixed grid, "defined" and "sampled" the
points passed with the batch (invalid ones are masked in the decoder's
self-attention).

AnchorDETR's other options (countdetr_tpu/models/anchor_detr.py:186-293):
``attention_type="MHA"`` (standard attention in place of RCDA, in the
transformer); ``num_feature_levels=3`` in stage 1 (C3, C4 and C5 each
projected to hidden_dim, C3 by a 3x3 stride-2 conv, so the three meet at
C5's stride 16); ``masks`` (DETRsegm's mask head over the last decoder
output and the encoder memory, with the C4, C3, C2 skips: ``pred_masks``
(B, L, H/4, W/4) float32 logits, models/segmentation.py).

Module names follow the reference torch model (``backbone.body.*``,
``input_proj.{lv}.{0,1}.*`` / ``aggr_input_proj.0.{0,1}.*``,
``transformer.*``, ``bbox_attention.*``, ``mask_head.*``), so a state_dict
maps to and from the JAX package's params by name (weights.py).
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
from countdetr_tpu_torch.models.segmentation import (
    MaskHeadSmallConv, MHAttentionMap, mask_head_forward,
)
from countdetr_tpu_torch.models.transformer import Transformer, init_transformer_
from countdetr_tpu_torch.ops.posemb import grid_reference_points
from countdetr_tpu_torch.utils import trace

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
    """Conv + masked GroupNorm(32) (reference anchor_detr.py:49-73), as the
    reference's Sequential(conv, norm): 1x1, or the 3x3 stride-2 conv of
    the lowest of three levels. NHWC in; the conv runs in float32 (the JAX
    package promotes it to its float32 parameters)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, kernel // 2),
                         MaskedGroupNorm(cout))

    def forward(self, x, valid=None):
        conv, norm = self[0], self[1]
        if conv.kernel_size == (1, 1) and conv.stride == (1, 1):
            x = F.linear(x.float(), conv.weight.flatten(1), conv.bias)
        else:
            x = conv(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
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


PRIORS = ("learned", "grid", "defined", "sampled")


class CountingDetr(nn.Module):
    """The counting detector of ``cfg.stage``.

    forward(images, pad_mask, *prior, generator=None, aux_outputs=None):
      images (B, H, W, 3) or s2d-packed (B, H/2, W/2, 12), raw uint8 or
        normalized float;
      pad_mask (B, H, W) bool, True on padding;
      prior: stage 1 (points (B, P, 2) normalized cx, cy, points_valid
        (B, P) bool); stage 2 (exemplar_boxes (B, K, 4) normalized xyxy,
        and under the defined or sampled prior points, points_valid).
        The learned and grid priors ignore the points; the defined and
        sampled priors raise without them;
      generator: a torch.Generator on the model's device; in training mode
        it draws the dropout masks (without one, or in eval mode, the model
        is deterministic, as the JAX package without a 'dropout' rng);
      aux_outputs: stage 2, whether to return the earlier decoder layers'
        {pred_logits, pred_boxes} (default: ``cfg.aux_loss``); False spares
        a caller that does not read them the heads of those layers;
      masks: with ``cfg.masks``, whether to run the mask head and return
        ``pred_masks`` (default True); False spares a caller that does not
        read them the head, whose activations grow with B * L.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        unsupported = []
        if cfg.stage not in (1, 2):
            unsupported.append("stages 1 and 2")
        if cfg.exemplar_aggregation != (cfg.stage == 2) or \
                cfg.with_variance_head != (cfg.stage == 2):
            unsupported.append("exemplar aggregation and the variance head in stage 2 "
                               "only")
        if cfg.backbone != "resnet50" or cfg.activation != "relu":
            unsupported.append("ResNet-50 and relu")
        if unsupported:
            raise NotImplementedError("the port supports only " + "; ".join(unsupported))
        if cfg.spatial_prior not in PRIORS:
            raise ValueError(f"unknown spatial prior {cfg.spatial_prior!r}")
        cfg.check_options()
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        C = cfg.hidden_dim
        multi_level = cfg.num_feature_levels > 1
        self.backbone = nn.ModuleDict({"body": ResNetBackbone(
            dilation=cfg.dilation, compute_dtype=dt,
            return_interm=multi_level or cfg.masks, return_c2=cfg.masks)})
        if multi_level:  # C3 (3x3 stride 2), C4, C5
            self.input_proj = nn.ModuleList([InputProj(512, C, 3, 2), InputProj(1024, C),
                                             InputProj(2048, C)])
        elif cfg.stage == 1:
            self.input_proj = nn.ModuleList([InputProj(2048, C)])
        else:
            self.aggr_input_proj = nn.ModuleList([InputProj(2 * 2048, C)])
        self.transformer = Transformer(cfg)
        if cfg.masks:
            self.bbox_attention = MHAttentionMap(C, C, cfg.nheads)
            self.mask_head = MaskHeadSmallConv(C + cfg.nheads, (1024, 512, 256), C)

    def reference_points(self, B: int, device, points=None, points_valid=None):
        """The prior's (reference_points (B, P, 2), query_valid (B, P) or None)."""
        prior = self.cfg.spatial_prior
        if prior == "learned":
            pos = self.transformer.position.weight
            return pos[None].expand(B, *pos.shape), None
        if prior == "grid":
            pos = grid_reference_points(self.cfg.num_query_position, device=device)
            return pos[None].expand(B, *pos.shape), None
        if points is None:
            raise ValueError(f"the {prior} prior needs points")
        return points, points_valid

    def forward(self, images, pad_mask, *prior, generator: Optional[torch.Generator] = None,
                aux_outputs: Optional[bool] = None, masks: bool = True):
        g = generator if self.training else None
        with trace.span("model.backbone"):
            if images.dtype == torch.uint8:
                images = normalize_uint8(images)
                # raw pads are 0, which normalizes to -mean/std: re-zero them so
                # the stem sees the same zeros as the host-normalized pipe
                packed = images.shape[-1] == 12
                pm = pack_mask_s2d(pad_mask) if packed else pad_mask[..., None]
                images = images.masked_fill(pm, 0.0)
            feats = self.backbone["body"](images, pad_mask)
        feats = feats if isinstance(feats, tuple) else (feats,)
        feat = feats[-1]
        h, w = feat.shape[1], feat.shape[2]
        fmask = downsample_mask(pad_mask, h, w)
        B = images.shape[0]
        if self.cfg.stage == 1:
            points, points_valid = (tuple(prior) + (None, None))[:2]
            ref, query_valid = self.reference_points(B, images.device, points, points_valid)
            if self.cfg.num_feature_levels > 1:  # (B, l, h, w, C)
                src = torch.stack([proj(f, ~fmask) for proj, f in zip(self.input_proj, feats)],
                                  dim=1)
            else:
                src = self.input_proj[0](feat, ~fmask)
            tr = self.transformer(src, fmask, ref, query_valid, generator=g)
            out = {
                "pred_logits": tr["cls"],
                "pred_points": tr["coord"][..., :2],
                "pred_wh": tr["coord"][..., 2:],
            }
        else:
            exemplar_boxes, points, points_valid = (tuple(prior) + (None, None))[:3]
            ref, query_valid = self.reference_points(B, images.device, points, points_valid)
            src = self.aggr_input_proj[0](exemplar_aggregate(feat, exemplar_boxes), ~fmask)
            aux = self.cfg.aux_loss if aux_outputs is None else aux_outputs
            tr = self.transformer(src, fmask, ref, query_valid, generator=g, all_layers=aux)
            last = (lambda x: x[-1]) if aux else (lambda x: x)
            out = {
                "pred_logits": last(tr["cls"]),
                "pred_boxes": last(tr["coord"]),
                "pred_vars": last(tr["var"]),
                "reference_points": tr["reference_points"],
            }
            if aux:
                out["aux_outputs"] = [{"pred_logits": tr["cls"][i], "pred_boxes": tr["coord"][i]}
                                      for i in range(tr["cls"].shape[0] - 1)]
        if self.cfg.masks and masks:  # skips C4, C3, C2 of (C2, C3, C4, C5)
            out["pred_masks"] = mask_head_forward(self.bbox_attention, self.mask_head, tr["hs"],
                                                  tr["memory"], fmask, feats[-2::-1])
        return out


@torch.no_grad()
def init_weights_(model: CountingDetr, g: torch.Generator):
    """Random initialisation from a seeded generator, following the JAX
    package's initialisers: lecun-normal backbone convs, identity frozen BN,
    xavier-uniform input projections (the fans of a 3x3 conv include its
    kernel area), the transformer's own scheme, and flax's defaults in the
    mask head (lecun-normal weights, zero biases, unit GroupNorm scales)."""
    def lecun_normal_(weight):
        weight.copy_(torch.randn(weight.shape, generator=g) / math.sqrt(weight[0].numel()))

    for m in model.backbone.modules():
        if isinstance(m, (Conv, StemConv)):
            lecun_normal_(m.weight)
    projs = model.input_proj if hasattr(model, "input_proj") else model.aggr_input_proj
    for proj in projs:
        conv = proj[0]
        cout, cin, kh, kw = conv.weight.shape
        limit = math.sqrt(6.0 / ((cin + cout) * kh * kw))
        conv.weight.copy_((torch.rand(conv.weight.shape, generator=g) * 2 - 1) * limit)
        conv.bias.zero_()
    init_transformer_(model.transformer, g)
    if model.cfg.masks:
        for m in (*model.bbox_attention.modules(), *model.mask_head.modules()):
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                state_dict: Optional[dict] = None) -> CountingDetr:
    """A CountingDetr on ``device`` in eval mode: weights from ``state_dict``
    (loaded strictly) or, without one, random from ``seed``. A trainer calls
    ``.train()`` and passes its dropout generator to the forward."""
    dev = resolve_device(device)
    model = CountingDetr(cfg)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()

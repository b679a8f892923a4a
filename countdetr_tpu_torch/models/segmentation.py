"""The mask head (countdetr_tpu/models/segmentation.py; reference
models/segmentation.py, DETR's DETRsegm carried by the reference behind
--masks and used by no script).

Per-query attention maps over the encoder memory (``MHAttentionMap``), an
FPN-style conv head that upsamples memory and maps to stride-4 masks with
the backbone's C4, C3, C2 as skips (``MaskHeadSmallConv``), the dice loss,
the focal + dice mask losses, and mask postprocessing. Module names are the
reference's (``bbox_attention.q_linear``, ``mask_head.lay1`` ... ``out_lay``,
``adapter1`` ... ``adapter3``, ``gn1`` ... ``gn5``), so its weights import by
name. Everything runs in float32.

Two numerics follow the JAX package rather than torch's defaults: the
GroupNorms' epsilon is flax's 1e-6 (torch's is 1e-5), with the largest
group count up to 8 that divides the channels; the trunk's resize to each
skip is ``jax.image.resize``'s "nearest", which is torch's "nearest-exact"
(pixel centres; torch's "nearest" floors and picks other pixels at 7 -> 13),
and ``postprocess_masks`` resizes bilinearly with antialiasing when it
shrinks, as ``jax.image.resize`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from countdetr_tpu_torch.ops.losses import sigmoid_focal_loss

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon


class MHAttentionMap(nn.Module):
    """Per-query multi-head attention weights over the feature map, with no
    value projection: queries (B, Q, C), features (B, h, w, C) and their
    padding mask (B, h, w) -> softmaxed maps (B, Q, n, h, w)."""

    def __init__(self, query_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(query_dim, hidden_dim)
        self.k_linear = nn.Linear(query_dim, hidden_dim)

    def forward(self, queries, features, pad_mask=None):
        B, Q, C = queries.shape
        h, w = features.shape[1], features.shape[2]
        n = self.num_heads
        d = C // n
        qh = self.q_linear(queries).reshape(B, Q, n, -1)
        kh = self.k_linear(features).reshape(B, h, w, n, -1)
        attn = torch.einsum("bqnd,bhwnd->bqnhw", qh, kh) * d ** -0.5
        if pad_mask is not None:
            # finite, so a fully padded row gets a uniform softmax, not NaN
            attn = attn.masked_fill(pad_mask[:, None, None], -1e30)
        return torch.softmax(attn.reshape(B, Q, n, h * w), dim=-1).reshape(B, Q, n, h, w)


def group_count(channels: int) -> int:
    """The reference's 8 groups, or the largest count below 8 that divides
    ``channels`` where 8 does not (test-scale widths only)."""
    return max(d for d in range(1, 9) if channels % d == 0)


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels: int):
        super().__init__(group_count(channels), channels, eps=GN_EPS)


class MaskHeadSmallConv(nn.Module):
    """The reference's FPN conv head: channels [dim, ctx/2, ctx/4, ctx/8,
    ctx/16] (dim = hidden_dim + nheads, ctx = hidden_dim); each skip, C4,
    C3 then C2, goes through a 1x1 adapter and is added to the trunk, resized
    to the skip's size, before the next 3x3 conv + GroupNorm + relu.

    forward(x (N, dim, h, w), skips) with N = B * Q and each skip (B, c, H,
    W), NCHW, coarse to fine -> mask logits (N, H2, W2) at the last skip's
    size. A skip is added to the Q query rows of its image by broadcasting
    (the reference's expand)."""

    def __init__(self, dim: int, fpn_dims: Sequence[int], context_dim: int):
        super().__init__()
        inter = [dim, context_dim // 2, context_dim // 4, context_dim // 8, context_dim // 16]
        for i in range(5):
            cin = inter[max(i - 1, 0)]
            self.add_module(f"lay{i + 1}", nn.Conv2d(cin, inter[i], 3, padding=1))
            self.add_module(f"gn{i + 1}", GroupNorm(inter[i]))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)
        for i, c in enumerate(fpn_dims):
            self.add_module(f"adapter{i + 1}", nn.Conv2d(c, inter[i + 1], 1))

    def block(self, i: int, y):
        return F.relu(getattr(self, f"gn{i}")(getattr(self, f"lay{i}")(y)))

    def forward(self, x, skips):
        y = self.block(2, self.block(1, x))
        for i, f in enumerate(skips):
            skip = getattr(self, f"adapter{i + 1}")(f)
            if y.shape[-2:] != skip.shape[-2:]:
                y = F.interpolate(y, size=skip.shape[-2:], mode="nearest-exact")
            B = skip.shape[0]
            y = (y.reshape(B, -1, *y.shape[1:]) + skip[:, None]).flatten(0, 1)
            y = self.block(i + 3, y)
        return self.out_lay(y)[:, 0]


def mask_head_forward(bbox_attention: MHAttentionMap, mask_head: MaskHeadSmallConv,
                      hs, memory, pad_mask, skips) -> torch.Tensor:
    """DETRsegm's branch as the JAX model wires it: hs (B, L, C) and memory
    (B, h, w, C), both cast to float32, give the attention maps; memory with
    each query's maps, (B*L, C + n, h, w), runs the conv head over the
    skips (C4, C3, C2 as (B, H, W, c), cast to float32). Returns pred_masks
    (B, L, H2, W2) float32 at stride 4."""
    hs, memory = hs.float(), memory.float()
    amaps = bbox_attention(hs, memory, pad_mask)  # (B, L, n, h, w)
    B, L, n, h, w = amaps.shape
    mem = memory.permute(0, 3, 1, 2)[:, None].expand(B, L, -1, h, w)
    x = torch.cat([mem, amaps], dim=2).reshape(B * L, -1, h, w)
    m = mask_head(x, [f.float().permute(0, 3, 1, 2) for f in skips])
    return m.reshape(B, L, *m.shape[1:])


def dice_loss(pred_logits, targets, num_boxes):
    """1 - (2|X.Y| + 1) / (|X| + |Y| + 1) of each mask row, summed, over
    num_boxes. pred_logits, targets (N, H*W)."""
    probs = torch.sigmoid(pred_logits)
    num = 2.0 * (probs * targets).sum(dim=1)
    den = probs.sum(dim=1) + targets.sum(dim=1)
    return (1.0 - (num + 1.0) / (den + 1.0)).sum() / num_boxes


def mask_losses(pred_masks, tgt_masks, valid, num_boxes) -> Dict[str, torch.Tensor]:
    """Focal and dice losses of matched masks (reference loss_masks):
    pred_masks, tgt_masks (N, H, W), valid (N,) bool."""
    N = pred_masks.shape[0]
    p = pred_masks.reshape(N, -1)
    t = tgt_masks.reshape(N, -1).to(p.dtype)
    v = valid.to(p.dtype)[:, None]
    focal = (sigmoid_focal_loss(p, t) * v).mean(dim=1).sum() / num_boxes
    return {"loss_mask": focal, "loss_dice": dice_loss(p * v, t * v, num_boxes)}


def postprocess_masks(mask_logits, target_hw: Tuple[int, int], threshold: float = 0.5):
    """Mask logits (N, h, w) resized bilinearly to target_hw (antialiased
    when shrinking) and binarized at ``threshold`` after the sigmoid
    (reference PostProcessSegm)."""
    resized = F.interpolate(mask_logits[:, None].float(), size=tuple(target_hw), mode="bilinear",
                            align_corners=False, antialias=True)[:, 0]
    return torch.sigmoid(resized) > threshold

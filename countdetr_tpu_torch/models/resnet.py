"""ResNet-50 (DC5) backbone with frozen BatchNorm (countdetr_tpu/models/resnet.py;
reference models/resnet.py, models/backbone.py:22-101).

Public tensors are NHWC, as in the JAX package; the convolutions run NCHW
inside. Module and buffer names are the reference torch model's
(``conv1``, ``bn1``, ``layer{s}.{i}.conv2``, ``downsample.0`` ...), so a
reference state_dict loads as it is.

Padding invariance: with a padding mask the padded region is re-zeroed
before the stem's maxpool and before every bottleneck 3x3, so features on
the valid region do not depend on the bucket. torchvision's DC5 quirk is
kept: layer4's first block has stride 1 and dilation 1, later blocks
dilation 2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = x * w/sqrt(var+eps) + (b - mean*w/sqrt(var+eps)); the factors are
    float32, applied in the activation's dtype. x is NCHW."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        bias = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


class Conv(nn.Conv2d):
    """Bias-free conv with torch-style symmetric padding, run in the input's
    dtype (the float32 weight is cast)."""

    def __init__(self, cin, cout, kernel, stride=1, dilation=1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=(kernel // 2) * dilation, dilation=dilation, bias=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, self.dilation)


def stem_s2d_weight(weight: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2 stem weight (64, 3, 7, 7) rewritten as the exact 4x4/s1
    weight (64, 12, 4, 4) over space-to-depth input:
    W'[t, s, (a,b,c)] = W[2t+a-1, 2s+b-1, c], zero outside [0, 7)."""
    k = weight.permute(2, 3, 1, 0)  # HWIO (7, 7, 3, 64)
    kp = F.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))  # low pad of 1 on H and W
    ks = kp.reshape(4, 2, 4, 2, 3, 64).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, 64)
    return ks.permute(3, 2, 0, 1).contiguous()


def apply_valid(x, valid):
    """Zero padded pixels. x NCHW, valid (B, H, W) {0, 1} or None."""
    return x if valid is None else x * valid[:, None]


class StemConv(nn.Module):
    """The 7x7/s2 stem. The parameter keeps the reference's (64, 3, 7, 7)
    layout; a 12-channel packed input runs the exact 4x4/s1 rewrite with the
    asymmetric (2, 1) padding, a 3-channel input the direct conv."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))

    def forward(self, x):  # NCHW
        w = self.weight.to(x.dtype)
        if x.shape[1] == 3:
            return F.conv2d(x, w, None, 2, 3)
        if x.shape[1] != 12:
            raise ValueError(f"stem expects 3 or 12 channels, got {x.shape[1]}")
        return F.conv2d(F.pad(x, (2, 1, 2, 1)), stem_s2d_weight(w))


class Bottleneck(nn.Module):
    """torchvision Bottleneck v1.5 (stride on the 3x3)."""

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(Conv(cin, planes * 4, 1, stride), FrozenBatchNorm(planes * 4))
            if downsample else None
        )

    def forward(self, x, valid=None):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = apply_valid(out, valid)
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """ResNet-50 up to C5 (stride 16 with DC5).

    forward(x, pad_mask): x is (B, H, W, 3) or the space-to-depth packed
    (B, H/2, W/2, 12); pad_mask (B, H, W) bool at image resolution, True on
    padding, or None. Returns C5 as (B, h, w, 2048) NHWC in compute_dtype;
    with ``return_interm`` the tuple (C3, C4, C5) (multi-level features),
    with ``return_c2`` too (C2, C3, C4, C5) (the mask head's skips), as the
    JAX backbone returns them. Each level is re-zeroed on its own padding
    (the valid mask at its resolution) before the convolutions that read it.
    """

    def __init__(self, dilation: bool = True, compute_dtype: torch.dtype = torch.float32,
                 return_interm: bool = False, return_c2: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.return_interm = return_interm
        self.return_c2 = return_c2
        self.conv1 = StemConv()
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            # DC5: layer4 keeps stride 1; its first block keeps dilation 1
            # (torchvision's _make_layer), the later ones dilate by 2
            stride, dil = (1, 2) if dilation and stage == 3 else (min(stage, 1) + 1, 1)
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(cin, planes, stride if i == 0 else 1,
                                         dil if i > 0 else 1, downsample=(i == 0)))
                cin = planes * 4
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
        # never trained (reference backbone.py:66-68): the stem and layer1;
        # every FrozenBatchNorm tensor is a buffer
        self.conv1.requires_grad_(False)
        self.layer1.requires_grad_(False)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)

        def valid_at(h, w):
            if pad_mask is None:
                return None
            return (~downsample_mask(pad_mask, h, w)).to(x.dtype)

        x = F.relu(self.bn1(self.conv1(x)))
        # relu output >= 0, so re-zeroed padding never wins the max
        x = apply_valid(x, valid_at(x.shape[2], x.shape[3]))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage in range(4):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, valid_at(x.shape[2], x.shape[3]))
            feats.append(x.permute(0, 2, 3, 1))
        if not self.return_interm:
            return feats[-1]
        return tuple(feats) if self.return_c2 else tuple(feats[1:])


def downsample_mask(pad_mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour downsample of the (B, H, W) padding mask to (h, w):
    index floor(arange(h) * (H / h)), computed in float32 as the JAX
    package does (reference backbone.py:85)."""
    B, H, W = pad_mask.shape
    dev = pad_mask.device
    sy = torch.tensor(H / h, dtype=torch.float32, device=dev)
    sx = torch.tensor(W / w, dtype=torch.float32, device=dev)
    yi = torch.floor(torch.arange(h, dtype=torch.float32, device=dev) * sy).long()
    xi = torch.floor(torch.arange(w, dtype=torch.float32, device=dev) * sx).long()
    return pad_mask[:, yi][:, :, xi]

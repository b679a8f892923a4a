"""The plain reference of the Counting-DETR forward, stages 1 and 2, in
PyTorch: the benchmark's yardstick for what the program serves.

Written from the model's description (Counting-DETR, arXiv 2207.10988, on
AnchorDETR, arXiv 2109.07107), as functions over a state dict whose keys
and shapes are the reference torch model's (``backbone.body.layer1.0.conv1
.weight``, ``transformer.encoder_layers.0.self_attn.in_proj_weight`` ...),
so the program and this file read the same tensors. It imports only torch
and numpy, builds no kernel, and runs every product in float32 with TF32
off (``forward`` sets both of torch's switches).

What it computes, image by image of a batch that it pads itself:
  * the ImageNet-normalised image, zero on the padding;
  * ResNet-50 with frozen BatchNorm, DC5 (layer4 at stride 16, its first
    block undilated, the rest dilated by 2), each level re-zeroed on its
    padding before the stem's max-pool and before each bottleneck's 3x3;
  * stage 2: exemplar aggregation (the C5 feature at each exemplar box's
    centre, averaged, modulates the map; [feat, feat * vec]); a 1x1 conv
    and GroupNorm(32) whose statistics see the valid pixels only;
  * the RCDA encoder (row and column keys averaged over the valid rows and
    columns; two 1-D softmaxes; out = sum_h sum_w a_col a_row v), the
    decoder (multi-head self-attention over the queries, invalid queries
    masked as keys; RCDA cross-attention), post-LayerNorm residuals, ReLU
    FFNs;
  * the heads of the last decoder layer: class logits, the box MLP with
    the (0, 0, -2, -2) offset added to its output and the anchor's logit
    to its centre, and in stage 2 the variance MLP.
The queries: stage 2 the 24 x 24 grid of 600 positions (x-major, cell
centres), stage 1 the annotated points.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMNET_MEAN = (0.485, 0.456, 0.406)
IMNET_STD = (0.229, 0.224, 0.225)
WH_OFFSET = (0.0, 0.0, -2.0, -2.0)
NEG = -1e30

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------- backbone ---

def frozen_bn(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    scale = p[key + ".weight"] * torch.rsqrt(p[key + ".running_var"] + 1e-5)
    shift = p[key + ".bias"] - p[key + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def downsample_mask(pad: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest rows and columns floor(i * (H / h)), the ratio in float32."""
    H, W = pad.shape[-2:]
    dev = pad.device
    yi = torch.floor(torch.arange(h, dtype=torch.float32, device=dev)
                     * torch.tensor(H / h, dtype=torch.float32, device=dev)).long()
    xi = torch.floor(torch.arange(w, dtype=torch.float32, device=dev)
                     * torch.tensor(W / w, dtype=torch.float32, device=dev)).long()
    return pad[:, yi][:, :, xi]


def _zero_pad(x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    keep = ~downsample_mask(pad, x.shape[2], x.shape[3])
    return x * keep[:, None].to(x.dtype)


def bottleneck(p: Params, key: str, x, pad, stride: int, dilation: int, down: bool):
    identity = x
    if down:
        identity = frozen_bn(p, key + ".downsample.1",
                             F.conv2d(x, p[key + ".downsample.0.weight"], stride=stride))
    out = F.relu(frozen_bn(p, key + ".bn1", F.conv2d(x, p[key + ".conv1.weight"])))
    out = _zero_pad(out, pad)
    out = F.conv2d(out, p[key + ".conv2.weight"], stride=stride, padding=dilation,
                   dilation=dilation)
    out = F.relu(frozen_bn(p, key + ".bn2", out))
    out = frozen_bn(p, key + ".bn3", F.conv2d(out, p[key + ".conv3.weight"]))
    return F.relu(out + identity)


BLOCKS = (3, 4, 6, 3)


def resnet50_dc5(p: Params, x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) normalised, pad (B, H, W) True on padding -> C5
    (B, H/16, W/16, 2048)."""
    key = "backbone.body"
    x = F.relu(frozen_bn(p, key + ".bn1", F.conv2d(x, p[key + ".conv1.weight"], stride=2,
                                                    padding=3)))
    x = F.max_pool2d(_zero_pad(x, pad), 3, 2, 1)
    for stage, n in enumerate(BLOCKS):
        for i in range(n):
            stride = 2 if (i == 0 and stage in (1, 2)) else 1
            dilation = 2 if (stage == 3 and i > 0) else 1
            x = bottleneck(p, f"{key}.layer{stage + 1}.{i}", x, pad, stride, dilation, i == 0)
    return x.permute(0, 2, 3, 1)


# -------------------------------------------------------------- projection ---

def group_norm_valid(p: Params, key: str, x: torch.Tensor, valid: torch.Tensor, groups=32):
    B, H, W, C = x.shape
    xg = x.reshape(B, H, W, groups, C // groups)
    v = valid[..., None, None].to(x.dtype)
    n = v.sum(dim=(1, 2, 3, 4), keepdim=True).clamp(min=1.0) * (C // groups)
    mean = (xg * v).sum(dim=(1, 2, 4), keepdim=True) / n
    var = ((xg - mean).square() * v).sum(dim=(1, 2, 4), keepdim=True) / n
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return xg.reshape(B, H, W, C) * p[key + ".weight"] + p[key + ".bias"]


def exemplar_aggregate(feat: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """The feature at each exemplar box's centre pixel (truncated, clipped),
    averaged over the exemplars, scales the map; [feat, feat * vec]."""
    B, h, w, C = feat.shape
    cx = (rects[..., 0] + rects[..., 2]) * 0.5 * w
    cy = (rects[..., 1] + rects[..., 3]) * 0.5 * h
    xi = cx.to(torch.int32).clamp(0, w - 1).long()
    yi = cy.to(torch.int32).clamp(0, h - 1).long()
    vec = feat[torch.arange(B, device=feat.device)[:, None], yi, xi].mean(dim=1)
    return torch.cat([feat, feat * vec[:, None, None, :]], dim=-1)


# ---------------------------------------------------------- embeddings ---

def posemb1d(pos: torch.Tensor, n: int) -> torch.Tensor:
    """sin on even features, cos on odd, temperature 10000."""
    pos = pos.float() * (2.0 * math.pi)
    i = torch.arange(n, dtype=torch.float32, device=pos.device)
    dim_t = torch.pow(torch.tensor(10000.0, device=pos.device), 2.0 * torch.floor(i / 2.0) / n)
    x = pos[..., None] / dim_t
    return torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])], dim=-1).reshape(
        *x.shape[:-1], n)


def posemb2d(pos: torch.Tensor, n: int) -> torch.Tensor:
    """pos (..., 2) as (x, y) -> (..., 2n), the y embedding first."""
    return torch.cat([posemb1d(pos[..., 1], n), posemb1d(pos[..., 0], n)], dim=-1)


def mask_positions(pad: torch.Tensor):
    """(rows (B, H), cols (B, W)): (cumsum(valid) - 0.5) / valid count,
    read along the first column and the first row."""
    y = torch.cumsum((~pad[:, :, 0]).float(), dim=1)
    x = torch.cumsum((~pad[:, 0, :]).float(), dim=1)
    return (y - 0.5) / y[:, -1:], (x - 0.5) / x[:, -1:]


def grid_anchors(num_position: int, device) -> torch.Tensor:
    n = round(math.sqrt(num_position))
    c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    xs, ys = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


# -------------------------------------------------------------- attention ---

def linear(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[key + ".weight"], p[key + ".bias"])


def layer_norm(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[key + ".weight"], p[key + ".bias"], 1e-5)


def mlp(p: Params, key: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = linear(p, f"{key}.layers.{i}", x)
        if i < n - 1:
            x = F.relu(x)
    return x


def adapt(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return linear(p, key + ".2", F.relu(linear(p, key + ".0", x)))


def rcda(p: Params, key: str, heads: int, q_row, q_col, k_row, k_col, value, pad):
    """Row-column decoupled attention. q_* (B, L, E); k_*, value (B, H, W, E);
    pad (B, H, W) True on padding. Returns (B, L, E)."""
    B, L, E = q_row.shape
    H, W = value.shape[1:3]
    d = E // heads
    w = p[key + ".in_proj_weight"].chunk(5)
    b = p[key + ".in_proj_bias"].chunk(5)
    qr = F.linear(q_row, w[0], b[0]) * d**-0.5
    qc = F.linear(q_col, w[1], b[1]) * d**-0.5
    valid_h = (~pad[:, :, 0]).float()  # (B, H)
    valid_w = (~pad[:, 0, :]).float()  # (B, W)
    kr = (F.linear(k_row, w[2], b[2]) * valid_h[:, :, None, None]).sum(1) \
        / valid_h.sum(1).clamp(min=1.0)[:, None, None]  # (B, W, E)
    kc = (F.linear(k_col, w[3], b[3]) * valid_w[:, None, :, None]).sum(2) \
        / valid_w.sum(1).clamp(min=1.0)[:, None, None]  # (B, H, E)
    v = F.linear(value, w[4], b[4]).reshape(B, H, W, heads, d)
    zero = torch.zeros((), device=pad.device)
    bias_w = torch.where(pad[:, 0, :], torch.tensor(NEG, device=pad.device), zero)
    bias_h = torch.where(pad[:, :, 0], torch.tensor(NEG, device=pad.device), zero)
    a_row = torch.softmax(torch.einsum("blnd,bwnd->bnlw", qr.reshape(B, L, heads, d),
                                       kr.reshape(B, W, heads, d))
                          + bias_w[:, None, None, :], dim=-1)
    a_col = torch.softmax(torch.einsum("blnd,bhnd->bnlh", qc.reshape(B, L, heads, d),
                                       kc.reshape(B, H, heads, d))
                          + bias_h[:, None, None, :], dim=-1)
    hid = torch.einsum("bnlw,bhwnd->bnlhd", a_row, v)
    out = torch.einsum("bnlh,bnlhd->blnd", a_col, hid).reshape(B, L, E)
    return linear(p, key + ".out_proj", out)


def mha(p: Params, key: str, heads: int, query, key_in, value, key_pad=None):
    """Multi-head attention, nn.MultiheadAttention's packed weights; key_pad
    (B, S) True on keys to ignore."""
    B, L, E = query.shape
    S = key_in.shape[1]
    d = E // heads
    w = p[key + ".in_proj_weight"].chunk(3)
    b = p[key + ".in_proj_bias"].chunk(3)
    q = (F.linear(query, w[0], b[0]) * d**-0.5).reshape(B, L, heads, d)
    k = F.linear(key_in, w[1], b[1]).reshape(B, S, heads, d)
    v = F.linear(value, w[2], b[2]).reshape(B, S, heads, d)
    scores = torch.einsum("blnd,bsnd->bnls", q, k)
    if key_pad is not None:
        scores = scores + torch.where(key_pad, torch.tensor(NEG, device=query.device),
                                      torch.zeros((), device=query.device))[:, None, None, :]
    out = torch.einsum("bnls,bsnd->blnd", torch.softmax(scores, dim=-1), v)
    return linear(p, key + ".out_proj", out.reshape(B, L, E))


def ffn(p: Params, key: str, x):
    y = linear(p, key + ".linear2", F.relu(linear(p, key + ".linear1", x)))
    return layer_norm(p, key + ".norm2", x + y)


# ------------------------------------------------------------ transformer ---

def transformer(p: Params, m: dict, src, pad, anchors, query_valid=None) -> Dict[str, torch.Tensor]:
    """src (B, H, W, C), pad (B, H, W), anchors (B, P, 2) -> the last
    decoder layer's heads."""
    heads, t = m["nheads"], "transformer"
    B, H, W, C = src.shape
    tgt = p[t + ".pattern.weight"][0].expand(B, anchors.shape[1], C)
    query_pad = None if query_valid is None else ~query_valid
    rows, cols = mask_positions(pad)
    emb_w = adapt(p, t + ".adapt_pos1d", posemb1d(cols, C))  # (B, W, C)
    emb_h = adapt(p, t + ".adapt_pos1d", posemb1d(rows, C))  # (B, H, C)
    x = src
    for i in range(m["enc_layers"]):
        key = f"{t}.encoder_layers.{i}"
        q_row = x + emb_w[:, None]
        q_col = x + emb_h[:, :, None]
        y = rcda(p, key + ".self_attn", heads, q_row.reshape(B, H * W, C),
                 q_col.reshape(B, H * W, C), q_row, q_col, x, pad).reshape(B, H, W, C)
        x = ffn(p, key + ".ffn", layer_norm(p, key + ".norm1", x + y))
    query_pos = adapt(p, t + ".adapt_pos2d", posemb2d(anchors, C // 2))
    pos_x = adapt(p, t + ".adapt_pos1d", posemb1d(anchors[..., 0], C))
    pos_y = adapt(p, t + ".adapt_pos1d", posemb1d(anchors[..., 1], C))
    k_row = x + emb_w[:, None]
    k_col = x + emb_h[:, :, None]
    out = tgt
    for i in range(m["dec_layers"]):
        key = f"{t}.decoder_layers.{i}"
        q = out + query_pos
        out = layer_norm(p, key + ".norm2",
                         out + mha(p, key + ".self_attn", heads, q, q, out, query_pad))
        y = rcda(p, key + ".cross_attn", heads, out + pos_x, out + pos_y, k_row, k_col, x, pad)
        out = ffn(p, key + ".ffn", layer_norm(p, key + ".norm1", out + y))
    delta = mlp(p, t + ".bbox_embed.0", out, 3) + torch.tensor(WH_OFFSET, device=out.device)
    xy = delta[..., :2] + inverse_sigmoid(anchors)
    heads_out = {"cls": linear(p, t + ".cls_embed.0", out),
                 "coord": torch.sigmoid(torch.cat([xy, delta[..., 2:]], dim=-1))}
    if m["with_variance_head"]:
        heads_out["var"] = mlp(p, t + ".bbox_variance.0", out, 3)
    return heads_out


# ------------------------------------------------------------------ model ---

def pad_into(image: np.ndarray, bucket: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad an (h, w, 3) uint8 image at its bottom and right into the
    bucket; (padded, pad mask True on padding). The image must fit."""
    H, W = bucket
    h, w = image.shape[:2]
    if h > H or w > W:
        raise ValueError(f"image {h}x{w} does not fit the bucket {H}x{W}")
    out = np.zeros((H, W, 3), np.uint8)
    out[:h, :w] = image
    pad = np.ones((H, W), bool)
    pad[:h, :w] = False
    return out, pad


def smallest_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    fits = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fits:
        raise ValueError(f"no bucket holds {h}x{w}")
    return min(fits, key=lambda b: b[0] * b[1])


def forward(p: Params, m: dict, images: torch.Tensor, pad: torch.Tensor,
            exemplars: Optional[torch.Tensor] = None, points: Optional[torch.Tensor] = None,
            points_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) uint8 padded into one bucket, pad (B, H, W); stage
    2 takes exemplars (B, K, 4) normalised xyxy, stage 1 points (B, P, 2)
    normalised (x, y) with points_valid. Returns float32 stage 2
    {pred_logits, pred_boxes, pred_vars}, stage 1 {pred_logits,
    pred_points, pred_wh}."""
    mean = torch.tensor(IMNET_MEAN, device=images.device)
    std = torch.tensor(IMNET_STD, device=images.device)
    x = ((images.float() / 255.0 - mean) / std).masked_fill(pad[..., None], 0.0)
    feat = resnet50_dc5(p, x.permute(0, 3, 1, 2), pad)
    B, h, w, _ = feat.shape
    fpad = downsample_mask(pad, h, w)
    if m["stage"] == 2:
        src = exemplar_aggregate(feat, exemplars)
        key = "aggr_input_proj.0"
        anchors = grid_anchors(m["num_query_position"], images.device)[None].expand(B, -1, -1)
        query_valid = None
    else:
        src, key = feat, "input_proj.0"
        anchors, query_valid = points, points_valid
    src = F.linear(src, p[key + ".0.weight"].flatten(1), p[key + ".0.bias"])
    src = group_norm_valid(p, key + ".1", src, ~fpad)
    out = transformer(p, m, src, fpad, anchors, query_valid)
    if m["stage"] == 2:
        return {"pred_logits": out["cls"], "pred_boxes": out["coord"], "pred_vars": out["var"]}
    return {"pred_logits": out["cls"], "pred_points": out["coord"][..., :2],
            "pred_wh": out["coord"][..., 2:]}


def run(p: Params, m: dict, requests: List[dict], device, block: int = 4
        ) -> List[Dict[str, np.ndarray]]:
    """The reference over ``requests`` (dicts of ``image`` (h, w, 3) uint8,
    ``bucket`` (H, W), and ``exemplars`` (K, 4) or ``points`` (P, 2)), in
    blocks of ``block`` requests of one bucket (stage 1: one request a
    block, at its own point count), float32 with TF32 off. Returns each
    request's outputs as float32 numpy arrays, in order."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    results: List[Optional[dict]] = [None] * len(requests)
    try:
        order = sorted(range(len(requests)), key=lambda i: tuple(requests[i]["bucket"]))
        step = block if m["stage"] == 2 else 1
        i = 0
        while i < len(order):
            bucket = tuple(requests[order[i]]["bucket"])
            idx = [order[i]]
            while len(idx) < step and i + len(idx) < len(order) and \
                    tuple(requests[order[i + len(idx)]]["bucket"]) == bucket:
                idx.append(order[i + len(idx)])
            i += len(idx)
            padded = [pad_into(requests[j]["image"], bucket) for j in idx]
            images = torch.from_numpy(np.stack([a for a, _ in padded])).to(device)
            pad = torch.from_numpy(np.stack([b for _, b in padded])).to(device)
            with torch.no_grad():
                if m["stage"] == 2:
                    ex = torch.from_numpy(np.stack([requests[j]["exemplars"] for j in idx])
                                          .astype(np.float32)).to(device)
                    out = forward(p, m, images, pad, exemplars=ex)
                else:
                    pts = torch.from_numpy(np.asarray(requests[idx[0]]["points"],
                                                      np.float32)[None]).to(device)
                    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=device)
                    out = forward(p, m, images, pad, points=pts, points_valid=valid)
            host = {k: v.float().cpu().numpy() for k, v in out.items()}
            for n, j in enumerate(idx):
                results[j] = {k: v[n] for k, v in host.items()}
            del out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return results

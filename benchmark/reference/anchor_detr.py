"""The plain reference of Anchor DETR R50-DC5 (arXiv 2109.07107) as the
program serves it, a stage-1 model under the learned prior, in PyTorch:
the yardstick for ``detr_coco_b8``.

It follows Anchor DETR's ``Transformer.forward`` (github.com/megvii-research
/AnchorDETR ``models/transformer.py``, which the Counting-DETR trees fork:
``CountDETR_147_1st_stage/models/transformer.py:99-148``): ``position``, an
embedding of P learned anchor points in (0, 1), and ``pattern``, one of N
pattern embeddings; the N x P queries are pattern-major, query n * P + i
holding pattern n as its content and anchor i as its reference point, the
anchors repeated once a pattern. The backbone, the input projection, the
RCDA encoder and decoder, MHA and the FFNs are ``model.py``'s functions,
imported; its ``transformer`` is not, since it gives every query the first
pattern's content, so ``transformer`` here repeats its layer loops with the
queries above. The heads: a class logit per class and query, and the box MLP
whose output, with the anchor's logit added to its centre, is the
normalised cxcywh box. One departure from Anchor DETR as published, kept
because the program has it: the box MLP's output carries the
Counting-DETR fork's (0, 0, -2, -2) width and height offset.

The weights: every tensor of ``weights.param_spec``, and
``transformer.position.weight`` (P, 2) drawn into (0, 1) (Anchor DETR
initialises it uniform on (0, 1)) as the normal CDF of its share of the
same one normal draw (``draw`` repeats ``weights.draw``'s cut over this
longer spec). It imports only torch, numpy and the reference's
own modules, builds no kernel, and runs every product in float32 with TF32
off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import weights
from benchmark.reference.model import (IMNET_MEAN, IMNET_STD, WH_OFFSET, Params, adapt,
                                       downsample_mask, ffn, group_norm_valid, inverse_sigmoid,
                                       layer_norm, linear, mask_positions, mha, mlp, pad_into,
                                       posemb1d, posemb2d, rcda, resnet50_dc5)

POSITION = "transformer.position.weight"


def param_spec(m: dict) -> weights.Spec:
    """``weights.param_spec`` and the learned anchor points."""
    return weights.param_spec(m) + [(POSITION, (m["num_query_position"], 2), "position")]


def draw(m: dict, w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict, float32 on ``device``: as ``weights.draw``, over
    ``param_spec``; the anchor points are the normal CDF of their draw, so
    uniform on (0, 1)."""
    spec = param_spec(m)
    total = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape, kind in spec:
        n = math.prod(shape)
        zk = z[at:at + n].view(shape)
        out[key] = (0.5 * (1.0 + torch.erf(zk / math.sqrt(2.0))) if kind == "position"
                    else weights._scale(kind, shape, zk, w))
        at += n
    return out


def draw_to_host(m: dict, w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``draw`` on ``device``, kept on the host (``weights.draw_to_host``)."""
    state = {k: v.cpu() for k, v in draw(m, w, seed, device).items()}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return state


def queries(p: Params, B: int):
    """(content (B, N P, C), reference points (B, N P, 2)), pattern-major."""
    pattern, pos = p["transformer.pattern.weight"], p[POSITION]
    N, C = pattern.shape
    P = pos.shape[0]
    tgt = pattern[None, :, None, :].expand(B, N, P, C).reshape(B, N * P, C)
    return tgt, pos[None].expand(B, P, 2).repeat(1, N, 1)


def transformer(p: Params, m: dict, src, pad) -> Dict[str, torch.Tensor]:
    """src (B, H, W, C), pad (B, H, W) -> the last decoder layer's
    {cls (B, Q, classes), box (B, Q, 4) normalised cxcywh}."""
    heads, t = m["nheads"], "transformer"
    B, H, W, C = src.shape
    tgt, anchors = queries(p, B)
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
        out = layer_norm(p, key + ".norm2", out + mha(p, key + ".self_attn", heads, q, q, out))
        y = rcda(p, key + ".cross_attn", heads, out + pos_x, out + pos_y, k_row, k_col, x, pad)
        out = ffn(p, key + ".ffn", layer_norm(p, key + ".norm1", out + y))
    delta = mlp(p, t + ".bbox_embed.0", out, 3) + torch.tensor(WH_OFFSET, device=out.device)
    xy = delta[..., :2] + inverse_sigmoid(anchors)
    return {"cls": linear(p, t + ".cls_embed.0", out),
            "box": torch.sigmoid(torch.cat([xy, delta[..., 2:]], dim=-1))}


def forward(p: Params, m: dict, images: torch.Tensor, pad: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) uint8 padded into one bucket, pad (B, H, W) ->
    float32 {pred_logits (B, Q, classes), pred_boxes (B, Q, 4) normalised
    cxcywh}."""
    mean = torch.tensor(IMNET_MEAN, device=images.device)
    std = torch.tensor(IMNET_STD, device=images.device)
    x = ((images.float() / 255.0 - mean) / std).masked_fill(pad[..., None], 0.0)
    feat = resnet50_dc5(p, x.permute(0, 3, 1, 2), pad)
    fpad = downsample_mask(pad, *feat.shape[1:3])
    key = "input_proj.0"
    src = F.linear(feat, p[key + ".0.weight"].flatten(1), p[key + ".0.bias"])
    src = group_norm_valid(p, key + ".1", src, ~fpad)
    out = transformer(p, m, src, fpad)
    return {"pred_logits": out["cls"], "pred_boxes": out["box"]}


def run(p: Params, m: dict, requests: List[dict], device, block: int = 4
        ) -> List[Dict[str, np.ndarray]]:
    """The reference over ``requests`` (dicts of ``image`` (h, w, 3) uint8
    and ``bucket`` (H, W)), in blocks of up to ``block`` requests of one
    bucket, float32 with TF32 off. Returns each request's outputs as
    float32 numpy arrays, in order."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    results: List[Optional[dict]] = [None] * len(requests)
    try:
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(requests)):
            groups.setdefault(tuple(requests[i]["bucket"]), []).append(i)
        for bucket, members in groups.items():
            for at in range(0, len(members), block):
                idx = members[at:at + block]
                padded = [pad_into(requests[j]["image"], bucket) for j in idx]
                images = torch.from_numpy(np.stack([a for a, _ in padded])).to(device)
                pad = torch.from_numpy(np.stack([b for _, b in padded])).to(device)
                with torch.no_grad():
                    out = forward(p, m, images, pad)
                host = {k: v.float().cpu().numpy() for k, v in out.items()}
                for n, j in enumerate(idx):
                    results[j] = {k: v[n] for k, v in host.items()}
                del out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return results

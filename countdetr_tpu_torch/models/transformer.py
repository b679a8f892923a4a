"""AnchorDETR transformer, single feature level, RCDA attention
(countdetr_tpu/models/transformer.py; reference models/transformer.py).

Layouts are the JAX package's: the encoder works on the (B, H, W, C) grid,
the decoder on (B, L, C) queries. Module names are the reference torch
model's (``encoder_layers.{i}.self_attn.in_proj_weight``, ``ffn.norm2``,
``cls_embed.0`` ...). The shared prediction heads are one module each,
held in a one-element ModuleList so their keys keep the reference's ``.0``.

dtype policy: parameters are float32 and are cast to the activation dtype
where they are used; position embeddings are computed in float32 and cast;
LayerNorm statistics are float32; head outputs are cast to float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.ops import rcda as rcda_ops
from countdetr_tpu_torch.ops.boxes import inverse_sigmoid
from countdetr_tpu_torch.ops.posemb import mask2pos, pos2posemb1d, pos2posemb2d

# The bbox head's wh bias (reference transformer.py:95) lives in the last
# layer's bias, as in the reference; weights.py adds it to JAX params.
WH_BIAS = (0.0, 0.0, -2.0, -2.0)


class Linear(nn.Linear):
    """nn.Linear run in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class MLP(nn.Module):
    """relu between layers (reference transformer.py:427-437)."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def adapt_pos(d_model):
    """2-layer MLP on sinusoidal embeddings (reference transformer.py:72-73)."""
    return nn.Sequential(Linear(d_model, d_model), nn.ReLU(), Linear(d_model, d_model))


class RCDAAttention(nn.Module):
    """Packed (5E, E) RCDA parameters, as the reference stores them."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(5 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(5 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def forward(self, query_row, query_col, key_row, key_col, value, key_padding_mask=None):
        dt = query_row.dtype
        return rcda_ops.rcda_attention(
            query_row, query_col, key_row, key_col, value,
            self.in_proj_weight.to(dt), self.in_proj_bias.to(dt),
            self.out_proj.weight.to(dt), self.out_proj.bias.to(dt),
            self.num_heads, key_padding_mask,
        )


class MHAttention(nn.Module):
    """nn.MultiheadAttention's packed (3E, E) parameters."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None):
        dt = query.dtype
        return rcda_ops.mha_attention(
            query, key, value, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt),
            self.out_proj.weight.to(dt), self.out_proj.bias.to(dt),
            self.num_heads, key_padding_mask,
        )


class FFN(nn.Module):
    """Post-LN feed-forward block (reference transformer.py:410-424)."""

    def __init__(self, d_model, d_ffn):
        super().__init__()
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class EncoderLayer(nn.Module):
    """RCDA self-attention over the feature grid (reference transformer.py:217-278)."""

    def __init__(self, d_model, d_ffn, num_heads):
        super().__init__()
        self.self_attn = RCDAAttention(d_model, num_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(self, src, pad_mask, posemb_row, posemb_col):
        q_row = src + posemb_row[:, None, :, :]  # (B, H, W, C)
        q_col = src + posemb_col[:, :, None, :]
        src2 = self.self_attn(q_row, q_col, q_row, q_col, src, key_padding_mask=pad_mask)
        return self.ffn(self.norm1(src + src2))


class DecoderLayer(nn.Module):
    """Query self-attention (MHA) + RCDA cross-attention
    (reference transformer.py:315-407)."""

    def __init__(self, d_model, d_ffn, num_heads):
        super().__init__()
        self.self_attn = MHAttention(d_model, num_heads)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = RCDAAttention(d_model, num_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(self, tgt, query_pos, query_pos_x, query_pos_y, src, pad_mask,
                posemb_row, posemb_col, query_pad=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, key_padding_mask=query_pad))
        k_row = src + posemb_row[:, None, :, :]
        k_col = src + posemb_col[:, :, None, :]
        tgt2 = self.cross_attn(tgt + query_pos_x, tgt + query_pos_y, k_row, k_col, src,
                               key_padding_mask=pad_mask)
        return self.ffn(self.norm1(tgt + tgt2))


class Transformer(nn.Module):
    """Encoder-decoder over one feature level with the shared heads.

    forward(src (B, H, W, C), pad_mask (B, H, W) bool, reference_points
    (B, P, 2)) returns the last decoder layer's
      cls (B, L, num_classes), coord (B, L, 4) sigmoid cxcywh,
      var (B, L, 2) when the variance head is on, reference_points (B, L, 2),
    all float32, with L = P * num_query_pattern.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.pattern = nn.Embedding(cfg.num_query_pattern, C)
        self.adapt_pos1d = adapt_pos(C)
        self.adapt_pos2d = adapt_pos(C)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(C, cfg.dim_feedforward, cfg.nheads) for _ in range(cfg.enc_layers))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(C, cfg.dim_feedforward, cfg.nheads) for _ in range(cfg.dec_layers))
        self.cls_embed = nn.ModuleList([Linear(C, cfg.num_classes)])
        self.bbox_embed = nn.ModuleList([MLP(C, C, 4, 3)])
        if cfg.with_variance_head:
            self.bbox_variance = nn.ModuleList([MLP(C, C, 2, 3)])

    def forward(self, src, pad_mask, reference_points):
        cfg = self.cfg
        dt = self.compute_dtype
        src = src.to(dt)
        B, H, W, C = src.shape
        P = reference_points.shape[1]
        npat = cfg.num_query_pattern
        L = P * npat

        # pattern embeddings tiled over positions, pattern-major
        tgt = self.pattern.weight[None, :, None, :].to(dt).expand(B, npat, P, C).reshape(B, L, C)
        ref = reference_points.repeat(1, npat, 1)

        pos_col, pos_row = mask2pos(pad_mask)
        posemb_row = self.adapt_pos1d(pos2posemb1d(pos_row, C).to(dt))  # (B, W, C)
        posemb_col = self.adapt_pos1d(pos2posemb1d(pos_col, C).to(dt))  # (B, H, C)
        x = src
        for layer in self.encoder_layers:
            x = layer(x, pad_mask, posemb_row, posemb_col)

        query_pos = self.adapt_pos2d(pos2posemb2d(ref, C // 2).to(dt))
        query_pos_x = self.adapt_pos1d(pos2posemb1d(ref[..., 0], C).to(dt))
        query_pos_y = self.adapt_pos1d(pos2posemb1d(ref[..., 1], C).to(dt))
        out = tgt
        for layer in self.decoder_layers:
            out = layer(out, query_pos, query_pos_x, query_pos_y, x, pad_mask,
                        posemb_row, posemb_col)

        delta = self.bbox_embed[0](out).float()
        xy = delta[..., :2] + inverse_sigmoid(ref)
        result = {
            "cls": self.cls_embed[0](out).float(),
            "coord": torch.sigmoid(torch.cat([xy, delta[..., 2:]], dim=-1)),
            "reference_points": ref,
        }
        if cfg.with_variance_head:
            result["var"] = self.bbox_variance[0](out).float()
        return result


@torch.no_grad()
def init_transformer_(tr: Transformer, g: torch.Generator):
    """Random initialisation following the JAX package's initialisers."""

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for m in tr.modules():
        if isinstance(m, nn.Linear):  # torch.nn.Linear defaults
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in tr.modules():
        if isinstance(m, (RCDAAttention, MHAttention)):
            fan_out, fan_in = m.in_proj_weight.shape
            uniform_(m.in_proj_weight, math.sqrt(6.0 / (fan_in + fan_out)))
            m.in_proj_bias.zero_()
            m.out_proj.bias.zero_()
    tr.pattern.weight.copy_(torch.randn(tr.pattern.weight.shape, generator=g))
    tr.cls_embed[0].bias.fill_(-math.log((1 - 0.01) / 0.01))
    last = tr.bbox_embed[0].layers[-1]
    last.weight.zero_()
    last.bias.copy_(torch.tensor(WH_BIAS))
    if tr.cfg.with_variance_head:
        last = tr.bbox_variance[0].layers[-1]
        last.weight.fill_(0.01)
        last.bias.fill_(0.01)

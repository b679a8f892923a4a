"""AnchorDETR transformer (countdetr_tpu/models/transformer.py; reference
models/transformer.py): RCDA or standard ("MHA") attention, one feature
level or three.

Layouts are the JAX package's: the encoder works on the (B, H, W, C) grid,
the decoder on (B, L, C) queries. Under ``attention_type="MHA"`` the
encoder's self-attention and the decoder's cross-attention are standard
attention over the H*W pixels, with the 2-D embedding of each pixel's
(x, y) as its position. With three feature levels (C3, C4, C5 projected to
one grid) the levels fold into the batch level-major, (l*B, H, W, C); half
the encoder layers are each followed by a level layer, attention across
the levels of each pixel; the decoder's cross-attention runs on the
queries tiled level-major, and ``level_fc`` merges the levels of each
query from the c-major, level-fastest flattening (c*l + level), the
order in which the reference's weights import. Module names are the reference torch
model's (``encoder_layers.{i}.self_attn.in_proj_weight``, ``ffn.norm2``,
``cls_embed.0`` ...). The shared prediction heads are one module each,
held in a one-element ModuleList so their keys keep the reference's ``.0``.

dtype policy: parameters are float32 and are cast to the activation dtype
where they are used; position embeddings are computed in float32 and cast;
LayerNorm statistics are float32; head outputs are cast to float32.

Dropout sits where the JAX layers put it, outside the attention cores: after
the FFN's activation and on its output, and on every attention block's
output. Its keep masks come from the ``torch.Generator`` a caller passes
(the counterpart of the JAX package's 'dropout' rng); without one the
layers are deterministic.

With ``remat`` each encoder and decoder layer (not a level layer, as in
the JAX package's nn.remat) runs under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward instead of
kept. The recompute draws the same dropout masks as the forward: the
generator's state is saved before the layer and restored for the
recompute (checkpoint's own ``preserve_rng_state`` covers the default
generators only, not a ``torch.Generator`` passed in). The attention
kernels run twice a layer then: the forward, and the recompute's forward.

Tensor parallelism (core/tensor_parallel.py): ``shard_params_tp`` gives
``RCDAAttention``, ``MHAttention`` and ``FFN`` their ``tp`` (a
``ModelShard``) and their local parameters. Each then runs nheads/M heads
(E/M of each role) or F/M hidden units: its inputs pass through
``copy_to_model``, its local partial output (``partial``) through
``reduce_from_model``, and its output bias is added once, after that.
The FFN's post-activation dropout draws the full-width mask and keeps the
rank's columns; every other dropout acts on replicated tensors and draws
the full tensor. So the M ranks of a model group draw from equal
generator states, the masks of one process.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from countdetr_tpu_torch.config import ModelConfig
from countdetr_tpu_torch.core.tensor_parallel import (
    ModelShard, copy_each_to_model, copy_to_model, reduce_from_model,
)
from countdetr_tpu_torch.ops import rcda as rcda_ops
from countdetr_tpu_torch.ops.boxes import inverse_sigmoid
from countdetr_tpu_torch.ops.posemb import mask2pos, pos2posemb1d, pos2posemb2d

# The bbox head's wh bias (reference transformer.py:95), added to the head's
# output outside the parameter, as the JAX package does
# (countdetr_tpu/models/transformer.py): the last layer's own bias starts at
# zero, so weight decay never pulls on the -2.
WH_BIAS = (0.0, 0.0, -2.0, -2.0)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard: Optional[ModelShard] = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): an element is kept with
    probability 1 - rate, drawn from ``generator`` on x's device, and scaled
    by 1 / (1 - rate). The identity without a generator or at rate 0. With
    ``shard``, x is model rank ``shard.index``'s block of the last
    dimension: the mask is drawn at the full width and the rank keeps its
    block, so the generator moves as in one process."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    n = x.shape[-1]
    shape = x.shape if shard is None else (*x.shape[:-1], n * shard.count)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(-1, shard.index * n, n)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def remat(layer: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """``layer(*args, generator=generator)`` with its activations recomputed
    in the backward (non-reentrant checkpoint); the recompute restores the
    generator to its state at the call, so it draws the forward's masks,
    and leaves it where the forward left it."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if start is None or len(calls) == 1:
            return layer(*a, generator=generator)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, generator=generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


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
    """Packed (5E, E) RCDA parameters, as the reference stores them;
    ``variant`` is the core's formulation (ModelConfig.rcda_variant).
    Under tensor parallelism (``tp``) the local (5E/M, E) rows hold this
    rank's heads of each role."""

    tp: Optional[ModelShard] = None

    def __init__(self, d_model, num_heads, variant="v3"):
        super().__init__()
        self.num_heads = num_heads
        self.variant = variant
        self.in_proj_weight = nn.Parameter(torch.empty(5 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(5 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def partial(self, query_row, query_col, key_row, key_col, value, key_padding_mask=None,
                bias=True):
        """The output of this module's heads (all of them without ``tp``);
        the output bias only with ``bias``."""
        dt = query_row.dtype
        heads = self.num_heads if self.tp is None else self.tp.local(self.num_heads, "nheads")
        return rcda_ops.rcda_attention(
            query_row, query_col, key_row, key_col, value,
            self.in_proj_weight.to(dt), self.in_proj_bias.to(dt),
            self.out_proj.weight.to(dt), self.out_proj.bias.to(dt) if bias else None,
            heads, key_padding_mask, self.variant,
        )

    def forward(self, query_row, query_col, key_row, key_col, value, key_padding_mask=None):
        if self.tp is None:
            return self.partial(query_row, query_col, key_row, key_col, value, key_padding_mask)
        inputs = copy_each_to_model((query_row, query_col, key_row, key_col, value), self.tp)
        out = reduce_from_model(self.partial(*inputs, key_padding_mask, bias=False), self.tp)
        return out + self.out_proj.bias.to(out.dtype)


class MHAttention(nn.Module):
    """nn.MultiheadAttention's packed (3E, E) parameters; under tensor
    parallelism (``tp``) the local (3E/M, E) rows hold this rank's heads of
    q, k and v."""

    tp: Optional[ModelShard] = None

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def partial(self, query, key, value, key_padding_mask=None, bias=True):
        """The output of this module's heads; the output bias only with ``bias``."""
        dt = query.dtype
        heads = self.num_heads if self.tp is None else self.tp.local(self.num_heads, "nheads")
        return rcda_ops.mha_attention(
            query, key, value, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt),
            self.out_proj.weight.to(dt), self.out_proj.bias.to(dt) if bias else None,
            heads, key_padding_mask,
        )

    def forward(self, query, key, value, key_padding_mask=None):
        if self.tp is None:
            return self.partial(query, key, value, key_padding_mask)
        inputs = copy_each_to_model((query, key, value), self.tp)
        out = reduce_from_model(self.partial(*inputs, key_padding_mask, bias=False), self.tp)
        return out + self.out_proj.bias.to(out.dtype)


class FFN(nn.Module):
    """Post-LN feed-forward block, dropout after the activation and on the
    output (reference transformer.py:410-424); under tensor parallelism
    (``tp``) this rank's F/M hidden units."""

    tp: Optional[ModelShard] = None

    def __init__(self, d_model, d_ffn, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def partial(self, x, generator=None, bias=True):
        """linear2 of this module's hidden units, before the residual and
        the output dropout; linear2's bias only with ``bias``."""
        h = dropout(F.relu(self.linear1(x)), self.dropout, generator, self.tp)
        return F.linear(h, self.linear2.weight.to(h.dtype),
                        self.linear2.bias.to(h.dtype) if bias else None)

    def forward(self, x, generator=None):
        if self.tp is None:
            y = self.partial(x, generator)
        else:
            y = reduce_from_model(self.partial(copy_to_model(x, self.tp), generator, bias=False),
                                  self.tp)
            y = y + self.linear2.bias.to(y.dtype)
        return self.norm2(x + dropout(y, self.dropout, generator))


def attention(attention_type, d_model, num_heads, variant):
    if attention_type == "RCDA":
        return RCDAAttention(d_model, num_heads, variant)
    return MHAttention(d_model, num_heads)


def flat_grid(x):
    """(B, H, W, C) -> (B, H*W, C); (B, H, W) -> (B, H*W)."""
    return x.reshape(x.shape[0], x.shape[1] * x.shape[2], *x.shape[3:])


class EncoderLayer(nn.Module):
    """Self-attention over the feature grid: RCDA, or standard attention
    over the H*W pixels (reference transformer.py:217-278)."""

    def __init__(self, d_model, d_ffn, num_heads, variant="v3", dropout=0.0,
                 attention_type="RCDA"):
        super().__init__()
        self.dropout = dropout
        self.attention_type = attention_type
        self.self_attn = attention(attention_type, d_model, num_heads, variant)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, dropout)

    def forward(self, src, pad_mask, posemb_row, posemb_col, posemb_2d=None, generator=None):
        if self.attention_type == "RCDA":
            q_row = src + posemb_row[:, None, :, :]  # (B, H, W, C)
            q_col = src + posemb_col[:, :, None, :]
            src2 = self.self_attn(q_row, q_col, q_row, q_col, src, key_padding_mask=pad_mask)
        else:
            q = flat_grid(src + posemb_2d)
            src2 = self.self_attn(q, q, flat_grid(src),
                                  key_padding_mask=flat_grid(pad_mask)).reshape(src.shape)
        src = self.norm1(src + dropout(src2, self.dropout, generator))
        return self.ffn(src, generator)


class LevelEncoderLayer(nn.Module):
    """Attention across the feature levels of each pixel, the level
    embedding added to queries and keys (reference
    TransformerEncoderLayerLevel, transformer.py:281-312)."""

    def __init__(self, d_model, d_ffn, num_heads, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn_level = MHAttention(d_model, num_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, dropout)

    def forward(self, src, level_emb, generator=None):
        # src (B, l, H, W, C), level_emb (l, C); one batch row a pixel
        B, l, H, W, C = src.shape
        x = src.permute(0, 2, 3, 1, 4).reshape(B * H * W, l, C)
        qk = x + level_emb[None].to(x.dtype)
        x2 = self.self_attn_level(qk, qk, x)
        x = self.ffn(self.norm1(x + dropout(x2, self.dropout, generator)), generator)
        return x.reshape(B, H, W, l, C).permute(0, 3, 1, 2, 4)


class DecoderLayer(nn.Module):
    """Query self-attention (MHA) + cross-attention over the grid, RCDA or
    standard (reference transformer.py:315-407); with levels, the
    cross-attention's per-level outputs merged by ``level_fc``."""

    def __init__(self, d_model, d_ffn, num_heads, variant="v3", dropout=0.0,
                 attention_type="RCDA", num_levels=1):
        super().__init__()
        self.dropout = dropout
        self.attention_type = attention_type
        self.num_levels = num_levels
        self.self_attn = MHAttention(d_model, num_heads)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = attention(attention_type, d_model, num_heads, variant)
        if num_levels > 1:
            self.level_fc = Linear(d_model * num_levels, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, dropout)

    def forward(self, tgt, query_pos, query_pos_x, query_pos_y, src, pad_mask,
                posemb_row, posemb_col, query_pad=None, posemb_2d=None, generator=None):
        B, L, C = tgt.shape
        l = self.num_levels
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, key_padding_mask=query_pad)
        tgt = self.norm2(tgt + dropout(tgt2, self.dropout, generator))

        def tile_l(x):  # (B, L, C) -> (l*B, L, C), level-major like src
            return x.repeat(l, 1, 1) if l > 1 else x

        if self.attention_type == "RCDA":
            k_row = src + posemb_row[:, None, :, :]
            k_col = src + posemb_col[:, :, None, :]
            tgt2 = self.cross_attn(tile_l(tgt + query_pos_x), tile_l(tgt + query_pos_y),
                                   k_row, k_col, src, key_padding_mask=pad_mask)
        else:
            tgt2 = self.cross_attn(tile_l(tgt + query_pos), flat_grid(src + posemb_2d),
                                   flat_grid(src),
                                   key_padding_mask=flat_grid(pad_mask))
        if l > 1:  # (l*B, L, C) -> (B, L, C*l), c-major with the level fastest
            tgt2 = self.level_fc(tgt2.reshape(l, B, L, C).permute(1, 2, 3, 0).reshape(B, L, C * l))
        tgt = self.norm1(tgt + dropout(tgt2, self.dropout, generator))
        return self.ffn(tgt, generator)


class Transformer(nn.Module):
    """Encoder-decoder with the shared heads.

    forward(src (B, H, W, C), or (B, l, H, W, C) with l feature levels,
    pad_mask (B, H, W) bool, reference_points (B, P, 2), query_valid (B, P)
    bool or None, generator, all_layers) returns the last decoder layer's
      cls (B, L, num_classes), coord (B, L, 4) sigmoid cxcywh,
      var (B, L, 2) when the variance head is on, reference_points (B, L, 2),
    all float32, with L = P * num_query_pattern, and for the mask head
    hs (B, L, C), the last decoder layer's output, and memory (l*B, H, W,
    C), the encoder's, in the compute dtype; with ``all_layers`` every
    decoder layer's cls, coord and var, stacked (D, B, L, .) as the JAX
    transformer returns them (the heads are one module each, applied after
    every layer). Queries that are not valid are masked as keys of the
    decoder's self-attention. ``generator`` turns dropout on.

    The learned prior's anchors are ``position`` (num_query_position, 2),
    held here under the reference's key ``transformer.position.weight``
    and read by the model (models/anchor_detr.py).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.pattern = nn.Embedding(cfg.num_query_pattern, C)
        if cfg.attention_type == "RCDA":  # the 1-D embeddings feed RCDA only
            self.adapt_pos1d = adapt_pos(C)
        self.adapt_pos2d = adapt_pos(C)
        nlv = cfg.num_feature_levels
        # with levels, half the encoder layers are level layers, each after
        # a spatial one (reference transformer.py:51-58)
        n_level = 0 if nlv == 1 else cfg.enc_layers // 2
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(C, cfg.dim_feedforward, cfg.nheads, cfg.rcda_variant, cfg.dropout,
                         cfg.attention_type)
            for _ in range(cfg.enc_layers - n_level))
        self.encoder_layers_level = nn.ModuleList(
            LevelEncoderLayer(C, cfg.dim_feedforward, cfg.nheads, cfg.dropout)
            for _ in range(n_level))
        if nlv > 1:
            self.level_embed = nn.Embedding(nlv, C)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(C, cfg.dim_feedforward, cfg.nheads, cfg.rcda_variant, cfg.dropout,
                         cfg.attention_type, nlv)
            for _ in range(cfg.dec_layers))
        self.cls_embed = nn.ModuleList([Linear(C, cfg.num_classes)])
        self.bbox_embed = nn.ModuleList([MLP(C, C, 4, 3)])
        # a constant, not a parameter: it moves with the model, is not saved
        self.register_buffer("wh_bias", torch.tensor(WH_BIAS), persistent=False)
        if cfg.with_variance_head:
            self.bbox_variance = nn.ModuleList([MLP(C, C, 2, 3)])
        if cfg.spatial_prior == "learned":
            self.position = nn.Embedding(cfg.num_query_position, 2)

    def forward(self, src, pad_mask, reference_points, query_valid=None,
                generator: Optional[torch.Generator] = None, all_layers: bool = False):
        cfg = self.cfg
        dt = self.compute_dtype
        src = src.to(dt)
        B = src.shape[0]
        nlv = cfg.num_feature_levels
        if src.dim() == 5:  # levels fold into the batch, level-major
            if src.shape[1] != nlv:
                raise ValueError(f"src has {src.shape[1]} levels, the config {nlv}")
            src = src.transpose(0, 1).reshape(nlv * B, *src.shape[2:])
            pad_mask = pad_mask.repeat(nlv, 1, 1)
        elif nlv != 1:
            raise ValueError(f"num_feature_levels={nlv} needs src (B, l, H, W, C)")
        _, H, W, C = src.shape
        P = reference_points.shape[1]
        npat = cfg.num_query_pattern
        L = P * npat

        # pattern embeddings tiled over positions, pattern-major
        tgt = self.pattern.weight[None, :, None, :].to(dt).expand(B, npat, P, C).reshape(B, L, C)
        ref = reference_points.repeat(1, npat, 1)
        query_pad = None if query_valid is None else ~query_valid.repeat(1, npat)

        pos_col, pos_row = mask2pos(pad_mask)
        posemb_row = posemb_col = posemb_2d = query_pos_x = query_pos_y = None
        if cfg.attention_type == "RCDA":
            posemb_row = self.adapt_pos1d(pos2posemb1d(pos_row, C).to(dt))  # (l*B, W, C)
            posemb_col = self.adapt_pos1d(pos2posemb1d(pos_col, C).to(dt))  # (l*B, H, C)
        else:  # each pixel's (x, y), stacked in that order
            n = pad_mask.shape[0]
            pos2d = torch.stack([pos_row[:, None, :].expand(n, H, W),
                                 pos_col[:, :, None].expand(n, H, W)], dim=-1)
            posemb_2d = self.adapt_pos2d(pos2posemb2d(pos2d, C // 2).to(dt))  # (B, H, W, C)
        # remat wraps the encoder and decoder layers, when there is a backward
        run = remat if cfg.remat and torch.is_grad_enabled() else (
            lambda layer, *a, generator: layer(*a, generator=generator))
        x = src
        for i, layer in enumerate(self.encoder_layers):
            x = run(layer, x, pad_mask, posemb_row, posemb_col, posemb_2d, generator=generator)
            if i < len(self.encoder_layers_level):
                x5 = x.reshape(nlv, B, H, W, C).transpose(0, 1)
                x5 = self.encoder_layers_level[i](x5, self.level_embed.weight, generator)
                x = x5.transpose(0, 1).reshape(nlv * B, H, W, C)

        query_pos = self.adapt_pos2d(pos2posemb2d(ref, C // 2).to(dt))
        if cfg.attention_type == "RCDA":
            query_pos_x = self.adapt_pos1d(pos2posemb1d(ref[..., 0], C).to(dt))
            query_pos_y = self.adapt_pos1d(pos2posemb1d(ref[..., 1], C).to(dt))
        ref_logit = inverse_sigmoid(ref)

        def heads(out):
            delta = self.bbox_embed[0](out).float() + self.wh_bias
            xy = delta[..., :2] + ref_logit
            h = {"cls": self.cls_embed[0](out).float(),
                 "coord": torch.sigmoid(torch.cat([xy, delta[..., 2:]], dim=-1))}
            if cfg.with_variance_head:
                h["var"] = self.bbox_variance[0](out).float()
            return h

        out, per_layer = tgt, []
        for i, layer in enumerate(self.decoder_layers):
            out = run(layer, out, query_pos, query_pos_x, query_pos_y, x, pad_mask,
                      posemb_row, posemb_col, query_pad, posemb_2d, generator=generator)
            if all_layers or i == len(self.decoder_layers) - 1:
                per_layer.append(heads(out))
        if all_layers:
            result = {k: torch.stack([h[k] for h in per_layer]) for k in per_layer[0]}
        else:
            result = per_layer[-1]
        result["reference_points"] = ref
        result["hs"], result["memory"] = out, x
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
    if tr.cfg.num_feature_levels > 1:
        tr.level_embed.weight.copy_(torch.randn(tr.level_embed.weight.shape, generator=g))
    tr.cls_embed[0].bias.fill_(-math.log((1 - 0.01) / 0.01))
    last = tr.bbox_embed[0].layers[-1]
    last.weight.zero_()
    last.bias.zero_()  # the wh bias is added in forward
    if tr.cfg.with_variance_head:
        last = tr.bbox_variance[0].layers[-1]
        last.weight.fill_(0.01)
        last.bias.fill_(0.01)
    if tr.cfg.spatial_prior == "learned":  # uniform [0, 1), as the JAX package
        tr.position.weight.copy_(torch.rand(tr.position.weight.shape, generator=g))

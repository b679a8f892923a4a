"""The weights both sides read: every tensor of the reference torch model's
state dict, drawn from the run's seed on the device in a few large calls.

``param_spec`` lists the keys, shapes and kinds of a configuration's model
(the ``model`` group of a file under ``benchmark/configs``); ``draw`` fills
them from one normal draw of a ``torch.Generator`` on ``device``, cut into
views and scaled by kind:
  * convolutions: lecun normal (std 1 / sqrt(fan in));
  * linears and packed attention projections: std 1 / sqrt(fan in);
  * biases, frozen-BatchNorm shifts and means, normalisation shifts: std
    0.02 or 0.1; frozen-BatchNorm and normalisation scales 1 + 0.1 z,
    variances 1 + 0.1 |z|;
  * the query pattern: std 1;
  * the class head: std ``cls_logit_std`` / sqrt(hidden) about the bias
    ``cls_bias`` (the config's ``weights`` group);
  * the box and variance heads' last layers are random too: a zero last
    layer (as a fresh model has) would leave every width and height the
    same for every image, and nothing of the image in stage 1's boxes.
Random weights give decoder outputs that differ far more from image to
image than from query to query, so every query of an image sits on the
same side of 0.5 and the count keeps all of them; what is compared (the
heads' outputs) still depends on every input.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _bn(key: str, c: int) -> Spec:
    return [(f"{key}.weight", (c,), "scale"), (f"{key}.bias", (c,), "shift"),
            (f"{key}.running_mean", (c,), "shift"), (f"{key}.running_var", (c,), "variance")]


def _linear(key: str, cin: int, cout: int, kind: str = "linear") -> Spec:
    return [(f"{key}.weight", (cout, cin), kind), (f"{key}.bias", (cout,), "bias")]


def _norm(key: str, c: int) -> Spec:
    return [(f"{key}.weight", (c,), "scale"), (f"{key}.bias", (c,), "shift")]


def backbone_spec() -> Spec:
    b = "backbone.body"
    spec: Spec = [(f"{b}.conv1.weight", (64, 3, 7, 7), "conv")] + _bn(f"{b}.bn1", 64)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(n):
            k = f"{b}.layer{stage + 1}.{i}"
            spec += [(f"{k}.conv1.weight", (planes, cin, 1, 1), "conv")] + _bn(f"{k}.bn1", planes)
            spec += [(f"{k}.conv2.weight", (planes, planes, 3, 3), "conv")]
            spec += _bn(f"{k}.bn2", planes)
            spec += [(f"{k}.conv3.weight", (planes * 4, planes, 1, 1), "conv")]
            spec += _bn(f"{k}.bn3", planes * 4)
            if i == 0:
                spec += [(f"{k}.downsample.0.weight", (planes * 4, cin, 1, 1), "conv")]
                spec += _bn(f"{k}.downsample.1", planes * 4)
            cin = planes * 4
    return spec


def _attention(key: str, c: int, parts: int) -> Spec:
    return [(f"{key}.in_proj_weight", (parts * c, c), "linear"),
            (f"{key}.in_proj_bias", (parts * c,), "bias")] + _linear(f"{key}.out_proj", c, c)


def _ffn(key: str, c: int, f: int) -> Spec:
    return _linear(f"{key}.linear1", c, f) + _linear(f"{key}.linear2", f, c) + \
        _norm(f"{key}.norm2", c)


def param_spec(m: dict) -> Spec:
    """(key, shape, kind) of every tensor of the model's state dict."""
    c, f = m["hidden_dim"], m["dim_feedforward"]
    spec = backbone_spec()
    if m["stage"] == 2:
        spec += [("aggr_input_proj.0.0.weight", (c, 4096, 1, 1), "linear"),
                 ("aggr_input_proj.0.0.bias", (c,), "bias")] + _norm("aggr_input_proj.0.1", c)
    else:
        spec += [("input_proj.0.0.weight", (c, 2048, 1, 1), "linear"),
                 ("input_proj.0.0.bias", (c,), "bias")] + _norm("input_proj.0.1", c)
    t = "transformer"
    spec += [(f"{t}.pattern.weight", (m["num_query_pattern"], c), "unit")]
    for name in ("adapt_pos1d", "adapt_pos2d"):
        spec += _linear(f"{t}.{name}.0", c, c) + _linear(f"{t}.{name}.2", c, c)
    for i in range(m["enc_layers"]):
        k = f"{t}.encoder_layers.{i}"
        spec += _attention(f"{k}.self_attn", c, 5) + _norm(f"{k}.norm1", c) + _ffn(f"{k}.ffn", c, f)
    for i in range(m["dec_layers"]):
        k = f"{t}.decoder_layers.{i}"
        spec += _attention(f"{k}.self_attn", c, 3) + _norm(f"{k}.norm2", c)
        spec += _attention(f"{k}.cross_attn", c, 5) + _norm(f"{k}.norm1", c)
        spec += _ffn(f"{k}.ffn", c, f)
    spec += [(f"{t}.cls_embed.0.weight", (m["num_classes"], c), "cls"),
             (f"{t}.cls_embed.0.bias", (m["num_classes"],), "cls_bias")]
    heads = [("bbox_embed", 4)] + ([("bbox_variance", 2)] if m["with_variance_head"] else [])
    for name, out in heads:
        for i, (a, b) in enumerate(((c, c), (c, c), (c, out))):
            spec += _linear(f"{t}.{name}.0.layers.{i}", a, b)
    return spec


def _scale(kind: str, shape: Tuple[int, ...], z: torch.Tensor, w: dict) -> torch.Tensor:
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind in ("conv", "linear"):
        return z / math.sqrt(fan_in)
    if kind == "bias":
        return z * 0.02
    if kind == "shift":
        return z * 0.1
    if kind == "scale":
        return 1.0 + 0.1 * z
    if kind == "variance":
        return 1.0 + 0.1 * z.abs()
    if kind == "unit":
        return z
    if kind == "cls":
        return z * (w["cls_logit_std"] / math.sqrt(shape[1]))
    if kind == "cls_bias":
        return w["cls_bias"] + 0.1 * z
    raise ValueError(f"unknown weight kind {kind!r}")


def draw_to_host(m: dict, w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``draw`` on ``device``, kept on the host: the reference's copy waits
    there while the card holds only the program's."""
    state = {k: v.cpu() for k, v in draw(m, w, seed, device).items()}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return state


def draw(m: dict, w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict, float32 on ``device``: one normal draw of all the
    elements from a generator seeded with ``seed``, cut and scaled."""
    spec = param_spec(m)
    total = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape, kind in spec:
        n = math.prod(shape)
        out[key] = _scale(kind, shape, z[at:at + n].view(shape), w)
        at += n
    return out

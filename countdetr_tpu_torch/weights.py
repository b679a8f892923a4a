"""Map the JAX package's parameters onto the port's state_dict.

``params_from_jax`` is the counterpart of the importer in
countdetr_tpu/train/checkpoints.py (``torch_state_dict_to_params``): it
takes the flax variables of a stage-1 or stage-2 CountingDetr as numpy
arrays (``{"params": {...}}``) and returns the port's state_dict, whose
keys are the reference torch model's. Conv kernels go HWIO -> OIHW, Dense
kernels (in, out) -> (out, in); the stem stays the reference's (64, 3, 7,
7). The learned prior's top-level ``position`` goes to the reference's
``transformer.position.weight``; the levels' ``input_proj_{lv}`` to
``input_proj.{lv}``, ``encoder_level_{i}`` to
``transformer.encoder_layers_level.{i}``; the mask head's
``bbox_attention`` and ``mask_head`` keep their names. Every JAX parameter
is used; one the mapping does not know raises.

The bbox head's wh bias [0, 0, -2, -2] is added in the forward, outside the
parameter, in the port as in the JAX package, so the head's last bias maps
as it is. The reference's .pth files fold the wh bias into that bias
(reference transformer.py:95): an importer of them subtracts it, as
countdetr_tpu/train/checkpoints.py does, and an exporter adds it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr, conv=False):
        a = np.array(arr, dtype=np.float32)  # a copy: the tensor owns writable memory
        if conv:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))

    def bn(prefix, m):
        for name in ("weight", "bias", "running_mean", "running_var"):
            put(f"{prefix}.{name}", m[name])

    def linear(prefix, m):
        put(f"{prefix}.weight", m["weight"])
        put(f"{prefix}.bias", m["bias"])

    def norm(prefix, m):
        put(f"{prefix}.weight", m["scale"])
        put(f"{prefix}.bias", m["bias"])

    def attn(prefix, m):
        put(f"{prefix}.in_proj_weight", m["in_proj_weight"])
        put(f"{prefix}.in_proj_bias", m["in_proj_bias"])
        put(f"{prefix}.out_proj.weight", m["out_proj_weight"])
        put(f"{prefix}.out_proj.bias", m["out_proj_bias"])

    def ffn(prefix, m):
        linear(f"{prefix}.linear1", m["linear1"])
        linear(f"{prefix}.linear2", m["linear2"])
        norm(f"{prefix}.norm2", m["norm2"])

    def mlp(prefix, m):
        for name, layer in m.items():
            j = int(name.split("_")[1])
            linear(f"{prefix}.layers.{j}", layer)

    def unknown(where, name):
        raise KeyError(f"params_from_jax: no mapping for {where}/{name}")

    def block(prefix, m, parts, where):
        """Each submodule of a layer by the mapper of its name."""
        for sub, mm in m.items():
            if sub not in parts:
                unknown(where, sub)
            parts[sub](f"{prefix}.{sub}", mm)

    def proj_block(prefix, m):
        put(f"{prefix}.0.weight", m["conv"]["kernel"], conv=True)
        put(f"{prefix}.0.bias", m["conv"]["bias"])
        norm(f"{prefix}.1", m["norm"])

    for name, m in p["backbone"].items():
        pre = "backbone.body"
        if name == "conv1":
            put(f"{pre}.conv1.weight", m["kernel"], conv=True)
        elif name == "bn1":
            bn(f"{pre}.bn1", m)
        elif name.startswith("layer"):
            stage, idx = name.split("_")
            for sub, mm in m.items():
                blk = f"{pre}.{stage}.{idx}"
                if sub.startswith("conv"):
                    put(f"{blk}.{sub}.weight", mm["kernel"], conv=True)
                elif sub.startswith("bn"):
                    bn(f"{blk}.{sub}", mm)
                elif sub == "downsample_conv":
                    put(f"{blk}.downsample.0.weight", mm["kernel"], conv=True)
                elif sub == "downsample_bn":
                    bn(f"{blk}.downsample.1", mm)
                else:
                    unknown(name, sub)
        else:
            unknown("backbone", name)

    # stage 1 projects C5 (input_proj) or each of three levels
    # (input_proj_{lv}), stage 2 the aggregated map (aggr_input_proj)
    projs = {}
    for name in p:
        if name in ("input_proj", "aggr_input_proj"):
            projs[name] = f"{name}.0"
        elif name.startswith("input_proj_"):
            projs[name] = f"input_proj.{int(name.split('_')[-1])}"
    for name, prefix in projs.items():
        proj_block(prefix, p[name])

    enc_parts = {"self_attn": attn, "self_attn_level": attn, "norm1": norm, "ffn": ffn}
    dec_parts = {"self_attn": attn, "cross_attn": attn, "norm1": norm, "norm2": norm,
                 "ffn": ffn, "level_fc": linear}
    for name, m in p["transformer"].items():
        pre = f"transformer.{name}"
        if name in ("pattern", "level_embed"):
            put(f"{pre}.weight", m)
        elif name in ("adapt_pos1d", "adapt_pos2d"):
            linear(f"{pre}.0", m["0"])
            linear(f"{pre}.2", m["2"])
        elif name.startswith("encoder_level_"):  # before the spatial layers' prefix
            block(f"transformer.encoder_layers_level.{name.split('_')[-1]}", m, enc_parts, name)
        elif name.startswith("encoder_"):
            block(f"transformer.encoder_layers.{name.split('_')[1]}", m, enc_parts, name)
        elif name.startswith("decoder_"):
            block(f"transformer.decoder_layers.{name.split('_')[1]}", m, dec_parts, name)
        elif name == "cls_embed":
            linear(f"{pre}.0", m)
        elif name in ("bbox_embed", "bbox_variance"):
            mlp(f"{pre}.0", m)
        else:
            unknown("transformer", name)

    if "position" in p:  # the learned prior's anchors
        put("transformer.position.weight", p["position"])

    if "bbox_attention" in p:  # the mask head; Dense kernels are (in, out)
        for name, m in p["bbox_attention"].items():
            put(f"bbox_attention.{name}.weight", np.asarray(m["kernel"]).T)
            put(f"bbox_attention.{name}.bias", m["bias"])
    for name, m in p.get("mask_head", {}).items():
        if name.startswith("gn"):
            norm(f"mask_head.{name}", m)
        else:
            put(f"mask_head.{name}.weight", m["kernel"], conv=True)
            put(f"mask_head.{name}.bias", m["bias"])

    extra = set(p) - {"backbone", "transformer", "position", "bbox_attention",
                      "mask_head", *projs}
    if extra:
        unknown("params", sorted(extra)[0])
    return sd

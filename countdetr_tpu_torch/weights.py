"""Map the JAX package's parameters onto the port's state_dict.

``params_from_jax`` is the counterpart of the importer in
countdetr_tpu/train/checkpoints.py (``torch_state_dict_to_params``): it
takes the flax variables of a stage-2 CountingDetr as numpy arrays
(``{"params": {...}}``) and returns the port's state_dict, whose keys are
the reference torch model's. Conv kernels go HWIO -> OIHW; the stem stays
the reference's (64, 3, 7, 7); the bbox head's last bias gains the wh bias
[0, 0, -2, -2] that the JAX forward adds explicitly. Every JAX parameter is
used; one the mapping does not know raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from countdetr_tpu_torch.models.transformer import WH_BIAS


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr, conv=False):
        a = np.asarray(arr, dtype=np.float32)
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

    def mlp(prefix, m, last_bias=None):
        for name, layer in m.items():
            j = int(name.split("_")[1])
            linear(f"{prefix}.layers.{j}", layer)
        if last_bias is not None:
            key = f"{prefix}.layers.{len(m) - 1}.bias"
            sd[key] = sd[key] + torch.tensor(last_bias, dtype=torch.float32)

    def unknown(where, name):
        raise KeyError(f"params_from_jax: no mapping for {where}/{name}")

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

    proj = p["aggr_input_proj"]
    put("aggr_input_proj.0.0.weight", proj["conv"]["kernel"], conv=True)
    put("aggr_input_proj.0.0.bias", proj["conv"]["bias"])
    norm("aggr_input_proj.0.1", proj["norm"])

    for name, m in p["transformer"].items():
        pre = f"transformer.{name}"
        if name == "pattern":
            put(f"{pre}.weight", m)
        elif name in ("adapt_pos1d", "adapt_pos2d"):
            linear(f"{pre}.0", m["0"])
            linear(f"{pre}.2", m["2"])
        elif name.startswith("encoder_"):
            pre = f"transformer.encoder_layers.{name.split('_')[1]}"
            attn(f"{pre}.self_attn", m["self_attn"])
            norm(f"{pre}.norm1", m["norm1"])
            ffn(f"{pre}.ffn", m["ffn"])
        elif name.startswith("decoder_"):
            pre = f"transformer.decoder_layers.{name.split('_')[1]}"
            attn(f"{pre}.self_attn", m["self_attn"])
            attn(f"{pre}.cross_attn", m["cross_attn"])
            norm(f"{pre}.norm1", m["norm1"])
            norm(f"{pre}.norm2", m["norm2"])
            ffn(f"{pre}.ffn", m["ffn"])
        elif name == "cls_embed":
            linear(f"{pre}.0", m)
        elif name == "bbox_embed":
            mlp(f"{pre}.0", m, last_bias=WH_BIAS)
        elif name == "bbox_variance":
            mlp(f"{pre}.0", m)
        else:
            unknown("transformer", name)

    extra = set(p) - {"backbone", "aggr_input_proj", "transformer"}
    if extra:
        unknown("params", sorted(extra)[0])
    return sd

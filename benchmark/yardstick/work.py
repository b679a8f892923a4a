"""The work a forward needs, counted from its inputs, and the chip's peaks:
what the per-layer metrics divide by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 3.35 TB/s of HBM; 495 TFLOP/s in TF32, the fastest rate of any
product of float32 inputs on the card (so a float32 configuration's share
of it cannot pass 100%); 989 TFLOP/s in bfloat16.

Counts are 2 FLOPs a multiply-add, at each image's own size and query
count, never at the bucket or point tier it was padded to, so that padding
cut away shows as a gain:
  * ``forward_flops``: every convolution, linear and attention product of
    the forward (ResNet-50-DC5 with its 7x7/2 stem, the input projection,
    the position MLPs, RCDA and MHA with their projections, the FFNs, the
    heads of the last decoder layer);
  * ``rcda_calls`` / ``mha_calls``: the attention cores' calls of one
    forward as (L, H, W) / (L, S), and ``rcda_work`` / ``mha_work`` the
    work any implementation of a core must do: RCDA 2 L E (H + W) for the
    two score products and 2 L E H W for the combine, summed over heads,
    the same for every formulation; MHA 4 L S E; bytes with each input
    read once and the output written once; no exponential bound.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _conv_out(n: int, k: int, s: int, pad: int, dil: int = 1) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // s + 1


def backbone_macs(h: int, w: int) -> Tuple[int, int, int]:
    """(multiply-adds, C5 height, C5 width) of ResNet-50-DC5 on an h x w
    image."""
    macs = 0
    h, w = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    macs += h * w * 64 * 3 * 49
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(n):
            s = 2 if (i == 0 and stage in (1, 2)) else 1
            d = 2 if (stage == 3 and i > 0) else 1
            macs += h * w * planes * cin
            ho, wo = _conv_out(h, 3, s, d, d), _conv_out(w, 3, s, d, d)
            macs += ho * wo * planes * planes * 9
            macs += ho * wo * planes * 4 * planes
            if i == 0:
                macs += ho * wo * planes * 4 * cin
            h, w, cin = ho, wo, planes * 4
    return macs, h, w


def num_queries(m: dict, n_points: int = 0) -> int:
    """The decoder's queries: the grid prior's n x n, else the points."""
    if m["spatial_prior"] == "grid":
        return round(math.sqrt(m["num_query_position"])) ** 2 * m["num_query_pattern"]
    return n_points * m["num_query_pattern"]


def rcda_calls(m: dict, h5: int, w5: int, q: int) -> List[Tuple[int, int, int]]:
    return [(h5 * w5, h5, w5)] * m["enc_layers"] + [(q, h5, w5)] * m["dec_layers"]


def mha_calls(m: dict, q: int) -> List[Tuple[int, int]]:
    return [(q, q)] * m["dec_layers"]


def rcda_work(L: int, H: int, W: int, E: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) one RCDA core call needs, all heads."""
    flops = 2 * L * E * (H + W) + 2 * L * E * H * W
    nbytes = itemsize * (3 * L * E + (H + W) * E + H * W * E + H + W)
    return float(flops), float(nbytes)


def mha_work(L: int, S: int, E: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) one MHA core call needs, all heads; the key bias is
    float32."""
    return float(4 * L * S * E), float(itemsize * (2 * L * E + 2 * S * E) + 4 * S)


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def forward_flops(m: dict, h: int, w: int, n_points: int = 0) -> float:
    """FLOPs of one image's forward at its own size (h, w) and query count."""
    macs, h5, w5 = backbone_macs(h, w)
    C, F = m["hidden_dim"], m["dim_feedforward"]
    hw = h5 * w5
    q = num_queries(m, n_points)
    macs += hw * (4096 if m["stage"] == 2 else 2048) * C  # input projection
    macs += (h5 + w5) * 2 * C * C  # the 1-D position MLP on rows and columns
    core = 0
    for L, H, W in rcda_calls(m, h5, w5, q):
        # q_row, q_col on the queries; k_row, k_col and v on the grid; out
        macs += 2 * L * C * C + 3 * H * W * C * C + L * C * C
        core += rcda_work(L, H, W, C, 4)[0]
    macs += m["enc_layers"] * 2 * hw * C * F
    macs += q * 2 * C * C * 3  # query_pos (2-D MLP) and the x, y 1-D MLPs
    for L, S in mha_calls(m, q):
        macs += 4 * L * C * C
        core += mha_work(L, S, C, 4)[0]
    macs += m["dec_layers"] * 2 * q * C * F
    macs += q * (C * m["num_classes"] + 2 * C * C + 4 * C)  # class and box heads
    if m["with_variance_head"]:
        macs += q * (2 * C * C + 2 * C)
    return 2.0 * macs + core


def core_bounds(m: dict, images: Iterable[Tuple[int, int, int]], dtype: str
                ) -> Tuple[float, float]:
    """(RCDA seconds, MHA seconds): the sum of the bound of every core call
    the forwards of ``images`` ((h, w, points) each, real images only)
    need."""
    isz = ITEMSIZE[dtype]
    C = m["hidden_dim"]
    rcda = mha = 0.0
    for h, w, n in images:
        _, h5, w5 = backbone_macs(h, w)
        q = num_queries(m, n)
        rcda += sum(bound_seconds(*rcda_work(L, H, W, C, isz), dtype)
                    for L, H, W in rcda_calls(m, h5, w5, q))
        mha += sum(bound_seconds(*mha_work(L, S, C, isz), dtype) for L, S in mha_calls(m, q))
    return rcda, mha

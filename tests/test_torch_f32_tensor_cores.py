"""The float32 attention kernels' 3xTF32 arithmetic against the JAX package, on the CPU.

``csrc/mha.cu`` and ``csrc/rcda.cu`` run float32 on Hopper's tensor cores
as three TF32 products per f32 product; they cannot run here, so this file
writes that arithmetic in torch: ``rna`` is ``cvt.rna.tf32.f32`` (10
mantissa bits, ties away from zero), each operand x splits into hi =
rna(x) and lo = rna(x - hi), and a product accumulates hi*lo + lo*hi, then
hi*hi, in f32 (lo*lo dropped). MHA: one pass over key tiles of 64 with the
online softmax, S = Q K^T and O += P V both in 3xTF32, P split after its
exponential. RCDA v3: both score products and hid = a_row v[h] in 3xTF32,
a_row split after its softmax, out += a_col[l, h] hid[h] in f32, one pass a
chunk of 64 columns past a 64-wide grid (the COCO detector's). Each is
held against the JAX package's einsum core and its Pallas kernel in
interpret mode within the f32 tolerances of test_torch_mha_online.py (1e-5)
and test_torch_rcda_combine.py (2e-5), on their shapes and padding at a
small size, and MHA at the level layer's 3 queries over 3 keys (one
batch row a pixel); one TF32 product alone misses them on the same inputs.
Last, which float32 v3 kernel the RCDA wrapper picks at the main path's
grids, at the COCO detector's and past the tensor-core kernel's limits.

This file checks the arithmetic, not the kernels: the kernels run only on
the card, where chip_smoke.py holds each of them against its plain version
within 1e-4 (its float32 rows and ``edge_cases``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops.pallas.mha_kernel import fused_mha, mha_core_einsum
from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda
from countdetr_tpu_torch.ops.kernels import rcda_kernel

LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
MHA_TOL, RCDA_TOL = 1e-5, 2e-5
KEY_TILE = 64


def rna(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away from
    zero (half an ulp added to the magnitude's bits, the low 13 cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna(x)
    return hi, rna(x - hi)


def einsum_tf32(eq, a, b, products=3):
    """``torch.einsum(eq, a, b)`` as the kernels' tensor cores compute it:
    3xTF32 (hi lo + lo hi, then hi hi, in f32), or one TF32 product."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if products == 1:
        return torch.einsum(eq, a_hi, b_hi)
    small = torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
    return small + torch.einsum(eq, a_hi, b_hi)


def mha_tf32(q, k, v, bias, num_heads, products=3):
    """csrc/mha.cu's float32 tensor-core kernel in torch: (B, L, E)."""
    b, l, e = q.shape
    S = k.shape[1]
    d = e // num_heads

    def heads(x):
        return x.reshape(b, -1, num_heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q), heads(k), heads(v)
    m = torch.full((b, num_heads, l), -FLT_MAX)
    z = torch.zeros(b, num_heads, l)
    o = torch.zeros(b, num_heads, l, d)
    for t0 in range(0, S, KEY_TILE):
        pad = max(0, t0 + KEY_TILE - S)  # keys past S: zero rows (TMA fill), bias -inf
        kt = torch.nn.functional.pad(kh[:, :, t0:t0 + KEY_TILE], (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vh[:, :, t0:t0 + KEY_TILE], (0, 0, 0, pad))
        bt = torch.nn.functional.pad(bias[:, t0:t0 + KEY_TILE], (0, pad), value=-float("inf"))
        s = einsum_tf32("bnld,bntd->bnlt", qh, kt, products)
        x = s * LOG2E + (bt * LOG2E)[:, None, None, :]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        z = z * alpha + p.sum(-1)
        o = o * alpha[..., None] + einsum_tf32("bnlt,bntd->bnld", p, vt, products)
        m = m_new
    return (o / z[..., None]).permute(0, 2, 1, 3).reshape(b, l, e)


def softmax2(x):
    """The kernels' softmax: 2^(x log2 e - max), normalised, in f32."""
    x = x * LOG2E
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def rcda_tf32(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads, products=3):
    """csrc/rcda.cu's float32 tensor-core kernel in torch: (B, L, E)."""
    B, L, E = q_row.shape
    H = v.shape[1]
    d = E // num_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], num_heads, d)

    s_row = einsum_tf32("blnd,bwnd->bnlw", heads(q_row), heads(k_row), products)
    s_col = einsum_tf32("blnd,bhnd->bnlh", heads(q_col), heads(k_col), products)
    a_row = softmax2(s_row + bias_row[:, None, None, :])
    a_col = softmax2(s_col + bias_col[:, None, None, :])
    vh = heads(v)  # (B, H, W, n, d)
    out = torch.zeros(B, num_heads, L, d)
    for w0 in range(0, v.shape[2], KEY_TILE):  # past 64 columns: one pass a chunk
        for h in range(H):
            hid = einsum_tf32("bnlw,bwnd->bnld", a_row[..., w0:w0 + KEY_TILE],
                              vh[:, h, w0:w0 + KEY_TILE], products)
            out = out + a_col[..., h, None] * hid
    return out.permute(0, 2, 1, 3).reshape(B, L, E)


def max_err(got, want):
    return float(np.abs(got.numpy() - want).max())


@functools.lru_cache(maxsize=None)
def mha_inputs(B, L, S):
    """test_torch_mha_online.py's inputs (B=3, L=20, E=64, 2 heads; image 1
    with part of its keys masked, image 2 with all) and the JAX package's
    einsum core and Pallas kernel (interpret mode) on them, float32."""
    E, n = 64, 2
    rng = np.random.default_rng(S)
    q = rng.normal(size=(B, L, E)).astype(np.float32) * (E // n) ** -0.5
    k = rng.normal(size=(B, S, E)).astype(np.float32)
    v = rng.normal(size=(B, S, E)).astype(np.float32) * 0.5
    bias = np.zeros((B, S), np.float32)
    bias[1, S // 2 + 1:] = -1e30
    bias[2, :] = -1e30
    jargs = [jnp.asarray(x) for x in (q, k, v, bias)]
    einsum = np.asarray(mha_core_einsum(*jargs, n))
    pallas = np.asarray(fused_mha(*jargs, n, interpret=True))
    return tuple(torch.from_numpy(x) for x in (q, k, v, bias)), n, einsum, pallas


# (B, L, S): test_torch_mha_online.py's key counts, and the level layer
MHA_SHAPES = [(3, 20, 23), (3, 20, 130), (3, 20, 576), (48, 3, 3)]


@pytest.mark.parametrize("B,L,S", MHA_SHAPES)
def test_mha_3xtf32_matches_jax(B, L, S):
    args, n, einsum, pallas = mha_inputs(B, L, S)
    got = mha_tf32(*args, n)
    assert torch.isfinite(got).all()
    assert max_err(got, einsum) <= MHA_TOL
    assert max_err(got, pallas) <= MHA_TOL
    # the fully masked image: the uniform softmax, the mean of its values
    v_mean = args[2][2].mean(0)
    assert (got[2] - v_mean).abs().max().item() <= MHA_TOL


@pytest.mark.parametrize("B,L,S", MHA_SHAPES)
def test_mha_one_tf32_product_misses(B, L, S):
    args, n, einsum, pallas = mha_inputs(B, L, S)
    got = mha_tf32(*args, n, products=1)
    assert min(max_err(got, einsum), max_err(got, pallas)) > MHA_TOL


@functools.lru_cache(maxsize=None)
def rcda_inputs(H, W, L):
    """test_torch_rcda_combine.py's inputs (B=2, E=64, 2 heads; image 1
    padded on the right and the bottom) and the JAX package's Pallas
    ``fused_rcda`` (interpret mode) on them, float32."""
    rng = np.random.default_rng(H * W + L)
    Bn, E, n = 2, 64, 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q_row, q_col = f(Bn, L, E) * (E // n) ** -0.5, f(Bn, L, E) * (E // n) ** -0.5
    k_row, k_col, v = f(Bn, W, E), f(Bn, H, E), f(Bn, H, W, E)
    bias_row = np.zeros((Bn, W), np.float32)
    bias_col = np.zeros((Bn, H), np.float32)
    bias_row[1, W - 7:] = -1e30
    bias_col[1, H - 5:] = -1e30
    args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col)
    with pltpu.force_tpu_interpret_mode():
        want = fused_rcda(*(jnp.asarray(x) for x in args), n, block_l=128)
    return tuple(torch.from_numpy(x) for x in args), n, np.asarray(want)


# the main path's grid, stage 1's, and the COCO detector's two past 64
RCDA_GRIDS = [(37, 37, 300), (24, 42, 200), (50, 84, 200), (84, 50, 200)]


@pytest.mark.parametrize("H,W,L", RCDA_GRIDS)
def test_rcda_3xtf32_matches_jax(H, W, L):
    args, n, want = rcda_inputs(H, W, L)
    got = rcda_tf32(*args, n)
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= RCDA_TOL


@pytest.mark.parametrize("H,W,L", RCDA_GRIDS)
def test_rcda_one_tf32_product_misses(H, W, L):
    args, n, want = rcda_inputs(H, W, L)
    assert max_err(rcda_tf32(*args, n, products=1), want) > RCDA_TOL


@pytest.mark.parametrize("H,W,d,route", [
    (37, 37, 32, "tensor_cores"),  # serving at 592x592
    (24, 42, 32, "tensor_cores"),  # stage 1's 384x672 bucket
    (37, 37, 64, "cuda_cores"),    # two warpgroups' q tiles would not fit
    (72, 104, 32, "tensor_cores"),  # two 64-wide chunks of each axis
    (50, 84, 32, "tensor_cores"),  # the COCO detector's 800x1344 bucket
    (84, 50, 32, "tensor_cores"),  # and its 1344x800 bucket
    (128, 128, 32, "tensor_cores"),  # the widest grid the 3xTF32 kernel takes
    (136, 80, 32, "cuda_cores"),   # past the 128 of two chunks
    (80, 129, 16, "cuda_cores"),
])
def test_rcda_f32_route(H, W, d, route):
    assert rcda_kernel.f32_route(H, W, d) == route


def test_rna_rounds_to_ten_mantissa_bits():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4, 1 + 3 * one_ulp / 4])
    assert rna(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp]
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs((hi + lo).item() - np.float32(np.pi)) <= 2.0 ** -21 * np.pi

"""Rank-1 RCDA in float32 on the v3 kernel's 3xTF32 arithmetic, on the CPU.

A float32 rank-1 call launches ``csrc/rcda.cu``'s float32 kernel, not a
kernel of ``csrc/rcda_rank1.cu``: the rank-1 formulation rounds the product
P = a_col * a_row once to v's dtype, the two-stage one each probability
map, and in float32 both roundings are the identity, so the two are one
function up to the order of an f32 sum. This file holds that route:
  * the 3xTF32 arithmetic of rcda.cu's tensor-core kernel
    (``rcda_tf32`` of test_torch_f32_tensor_cores.py) against the JAX
    package's Pallas ``fused_rcda_rank1`` in interpret mode, float32, at a
    37x37 grid and the stage-1 24x42 grid with one padded image, within
    2e-5 (the f32 tolerance of test_torch_rank1_combine.py); one TF32
    product alone misses it on the same inputs;
  * the two plain cores agree within 2e-6 in float32 at the stage-1 shapes
    and part by more than 1e-3 in bfloat16, where the rank-1 kernel keeps
    its own numerics;
  * ``kernel_route``: which source and code take a CUDA call of each
    variant and dtype, and where none does.
The kernels themselves run only on the card, where chip_smoke.py holds each
float32 rank-1 case against ``rcda_rank1_core_plain`` within 1e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda_rank1
from countdetr_tpu_torch.ops.kernels import rcda_kernel
from test_torch_f32_tensor_cores import max_err, rcda_tf32

TOL = 2e-5
PLAIN_F32_TOL = 2e-6


@functools.lru_cache(maxsize=None)
def rank1_inputs(H, W, L):
    """B=2, E=64, 2 heads, image 1 padded on the right and the bottom, and
    the JAX package's Pallas ``fused_rcda_rank1`` (interpret mode) on them,
    float32."""
    rng = np.random.default_rng(H * W + L + 2)
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
        want = fused_rcda_rank1(*(jnp.asarray(x) for x in args), n, block_l=128)
    return tuple(torch.from_numpy(x) for x in args), n, np.asarray(want)


GRIDS = [(37, 37, 300), (24, 42, 200)]


@pytest.mark.parametrize("H,W,L", GRIDS)
def test_rank1_on_3xtf32_matches_jax(H, W, L):
    args, n, want = rank1_inputs(H, W, L)
    got = rcda_tf32(*args, n)
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= TOL


@pytest.mark.parametrize("H,W,L", GRIDS)
def test_rank1_one_tf32_product_misses(H, W, L):
    args, n, want = rank1_inputs(H, W, L)
    assert max_err(rcda_tf32(*args, n, products=1), want) > TOL


def stage1_inputs(L, dtype):
    """Stage 1's RCDA call at B=2: C5 24x42 of the 384x672 bucket, E=256, 8
    heads, image 1 padded to 34 columns and 20 rows."""
    rng = np.random.default_rng(L)
    B, H, W, E, n = 2, 24, 42, 256, 8
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bias_row, bias_col = torch.zeros(B, W), torch.zeros(B, H)
    bias_row[1, 34:] = -1e30
    bias_col[1, 20:] = -1e30
    xs = (f(B, L, E) * (E // n) ** -0.5, f(B, L, E) * (E // n) ** -0.5, f(B, W, E),
          f(B, H, E), f(B, H, W, E), bias_row, bias_col)
    return tuple(x.to(dtype) for x in xs), n


def plain_gap(L, dtype):
    args, n = stage1_inputs(L, dtype)
    v3 = rcda_kernel.rcda_core_plain(*args, n).float()
    rank1 = rcda_kernel.rcda_rank1_core_plain(*args, n).float()
    assert torch.isfinite(v3).all() and torch.isfinite(rank1).all()
    return (v3 - rank1).abs().max().item()


@pytest.mark.parametrize("L", [1008, 700])
def test_plain_cores_are_one_function_in_float32(L):
    assert plain_gap(L, torch.float32) <= PLAIN_F32_TOL


def test_plain_cores_part_in_bfloat16():
    assert plain_gap(700, torch.bfloat16) > 1e-3


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("variant,dtype,H,W,d,want", [
    ("rank1", F32, 24, 42, 32, ("rcda", rcda_kernel.F32_TENSOR_CORES)),  # stage 1
    ("v3", F32, 24, 42, 32, ("rcda", rcda_kernel.F32_TENSOR_CORES)),
    ("rank1", F32, 37, 37, 32, ("rcda", rcda_kernel.F32_TENSOR_CORES)),  # 592x592
    ("rank1", F32, 80, 80, 32, ("rcda", rcda_kernel.F32_TENSOR_CORES)),  # two chunks of 64
    ("v3", F32, 80, 80, 32, ("rcda", rcda_kernel.F32_TENSOR_CORES)),
    ("rank1", F32, 136, 80, 32, ("rcda", 0)),  # past 128: rcda.cu's CUDA cores
    ("v3", F32, 136, 80, 32, ("rcda", 0)),
    ("rank1", F32, 37, 37, 64, ("rcda", 0)),  # d = 64
    ("v3", F32, 37, 37, 64, ("rcda", 0)),
    ("rank1", BF16, 37, 37, 32, ("rcda_rank1", 1)),
    ("v3", BF16, 37, 37, 32, ("rcda", 1)),
])
def test_kernel_route(variant, dtype, H, W, d, want):
    assert rcda_kernel.kernel_route(variant, dtype, H, W, d) == want


@pytest.mark.parametrize("variant", ["rank1", "v3"])
def test_no_bfloat16_kernel_past_64(variant):
    with pytest.raises(ValueError, match="H, W <= 64"):
        rcda_kernel.kernel_route(variant, BF16, 80, 80, 32)
    # _check, the wrapper's validation before a launch, refuses the call
    # too, and passes a float32 one of the same shape to rcda.cu's 3xTF32
    # kernel
    B, L, E, n = 1, 5, 64, 2
    args = [torch.zeros(B, L, E), torch.zeros(B, L, E), torch.zeros(B, 80, E),
            torch.zeros(B, 80, E), torch.zeros(B, 80, 80, E), torch.zeros(B, 80),
            torch.zeros(B, 80)]
    assert rcda_kernel._check(*args, n, variant) == ("rcda", rcda_kernel.F32_TENSOR_CORES)
    with pytest.raises(ValueError, match="H, W <= 64"):
        rcda_kernel._check(*(x.to(BF16) for x in args), n, variant)

"""The rank-1 RCDA combine arithmetic against the JAX package, on the CPU.

``csrc/rcda_rank1.cu`` (the bfloat16 rank-1 kernel) cannot run here, so
``rank1_combine`` writes the rank-1 rounding points in torch: f32 scores
plus the bias, both softmaxes in f32 as 2^(x log2 e - max) and neither
rounded; for each H row, P_h = a_col[:, h] * a_row in f32, rounded once
to the value dtype, with W padded to a multiple of 16 by zero columns (and
zero value rows); one f32 accumulation of P_h v[h] over all h, rounded
once to q's dtype. That is held against the JAX package's Pallas
``fused_rcda_rank1`` in interpret mode at a 37x37 grid with a padded image
and at the stage-1 24x42 grid: within 2e-2 in bfloat16 (the rank-1
kernel's tolerance against its plain version) and 2e-5 in float32. A
float32 rank-1 call runs csrc/rcda.cu's 3xTF32 kernel instead
(test_torch_rank1_f32.py); here float32 checks the rank-1 arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda_rank1

LOG2E = 1.4426950408889634
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def softmax2(x):
    """The kernel's softmax: 2^(x log2 e - max), normalised, in f32."""
    x = x * LOG2E
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def rank1_combine(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """The rank-1 arithmetic (csrc/rcda_rank1.cu's in bfloat16) in torch:
    (B, L, E) in q_row's dtype."""
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    d = E // num_heads
    w_pad = (W + 15) // 16 * 16

    def heads(x):
        return x.reshape(*x.shape[:-1], num_heads, d).float()

    s_row = torch.einsum("blnd,bwnd->bnlw", heads(q_row), heads(k_row))
    s_col = torch.einsum("blnd,bhnd->bnlh", heads(q_col), heads(k_col))
    a_row = softmax2(s_row + bias_row.float()[:, None, None, :])  # f32, not rounded
    a_col = softmax2(s_col + bias_col.float()[:, None, None, :])
    a_row = torch.nn.functional.pad(a_row, (0, w_pad - W))  # zero columns past W
    vh = torch.nn.functional.pad(heads(v), (0, 0, 0, 0, 0, w_pad - W))  # (B, H, Wp, n, d)
    out = torch.zeros(B, num_heads, L, d)
    for h in range(H):
        p_h = (a_col[..., h, None] * a_row).to(v.dtype).float()  # rounded once
        out = out + torch.einsum("bnlw,bwnd->bnld", p_h, vh[:, h])
    return out.permute(0, 2, 1, 3).reshape(B, L, E).to(q_row.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,W,L", [(37, 37, 300), (24, 42, 200)])
def test_combine_matches_fused_rcda_rank1(H, W, L, dtype):
    rng = np.random.default_rng(H * W + L + 1)
    Bn, E, n = 2, 64, 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q_row, q_col = f(Bn, L, E) * (E // n) ** -0.5, f(Bn, L, E) * (E // n) ** -0.5
    k_row, k_col, v = f(Bn, W, E), f(Bn, H, E), f(Bn, H, W, E)
    bias_row = np.zeros((Bn, W), np.float32)
    bias_col = np.zeros((Bn, H), np.float32)
    if H == W:  # image 1 padded on the right and the bottom
        bias_row[1, W - 7:] = -1e30
        bias_col[1, H - 5:] = -1e30
    args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = rank1_combine(*(torch.from_numpy(x).to(tdt) for x in args), n).float().numpy()
    with pltpu.force_tpu_interpret_mode():
        want = fused_rcda_rank1(*(jnp.asarray(x).astype(jdt) for x in args), n, block_l=128)
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)

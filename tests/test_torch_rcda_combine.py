"""The RCDA kernel's combine arithmetic against the JAX package, on the CPU.

``csrc/rcda.cu`` cannot run here, so ``rcda_combine`` writes its rounding
points in torch: f32 scores plus the bias and f32 softmaxes (as 2^(x log2 e
- max)), a_row rounded to the value dtype, a_col kept in f32, for each H
row hid = a_row v[h] accumulated in f32, and out = sum over h of
a_col[l, h] * hid in f32, rounded once to q's dtype. That is held against
the JAX package's Pallas ``fused_rcda`` in interpret mode (which rounds the
a_col-weighted hid to the value dtype before folding the heads) within
2e-2 in bfloat16, 2e-5 in float32, at a 37x37 grid with a padded image and
at the stage-1 24x42 grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda

LOG2E = 1.4426950408889634
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def softmax2(x):
    """The kernel's softmax: 2^(x log2 e - max), normalised, in f32."""
    x = x * LOG2E
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def rcda_combine(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """csrc/rcda.cu's arithmetic in torch: (B, L, E) in q_row's dtype."""
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    d = E // num_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], num_heads, d).float()

    s_row = torch.einsum("blnd,bwnd->bnlw", heads(q_row), heads(k_row))
    s_col = torch.einsum("blnd,bhnd->bnlh", heads(q_col), heads(k_col))
    a_row = softmax2(s_row + bias_row.float()[:, None, None, :]).to(v.dtype).float()
    a_col = softmax2(s_col + bias_col.float()[:, None, None, :])
    vh = heads(v)  # (B, H, W, n, d), exact in f32
    out = torch.zeros(B, num_heads, L, d)
    for h in range(H):
        hid = torch.einsum("bnlw,bwnd->bnld", a_row, vh[:, h])
        out = out + a_col[..., h, None] * hid
    return out.permute(0, 2, 1, 3).reshape(B, L, E).to(q_row.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,W,L", [(37, 37, 300), (24, 42, 200)])
def test_combine_matches_fused_rcda(H, W, L, dtype):
    rng = np.random.default_rng(H * W + L)
    Bn, E, n = 2, 64, 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q_row, q_col = f(Bn, L, E) * (E // n) ** -0.5, f(Bn, L, E) * (E // n) ** -0.5
    k_row, k_col, v = f(Bn, W, E), f(Bn, H, E), f(Bn, H, W, E)
    bias_row = np.zeros((Bn, W), np.float32)
    bias_col = np.zeros((Bn, H), np.float32)
    bias_row[1, W - 7:] = -1e30  # image 1 padded on the right and the bottom
    bias_col[1, H - 5:] = -1e30
    args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = rcda_combine(*(torch.from_numpy(x).to(tdt) for x in args), n).float().numpy()
    with pltpu.force_tpu_interpret_mode():
        want = fused_rcda(*(jnp.asarray(x).astype(jdt) for x in args), n, block_l=128)
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)

"""The port's rank-1 RCDA core against the JAX package, on the CPU.

``rcda_rank1_core_plain`` (the oracle of csrc/rcda_rank1.cu) against the
JAX package's Pallas ``fused_rcda_rank1`` run in interpret mode, at the
shapes of tests/test_pallas_rcda.py plus padded biases: float32, atol 1e-5
(the Pallas kernel builds P through an expand-matrix product and sums in
another order). The core's gradient under variant="rank1" is the two-stage
plain core's, as the JAX package's backward is for either variant.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda_rank1

from countdetr_tpu_torch.ops.kernels import rcda_kernel
from countdetr_tpu_torch.ops.kernels.rcda_kernel import rcda_core_plain, rcda_rank1_core_plain

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rank1_inputs(rng, B, L, H, W, E, pad_w=0, pad_h=0):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bias_row = np.zeros((B, W), np.float32)
    bias_col = np.zeros((B, H), np.float32)
    bias_row[-1, W - pad_w:] = -1e30 if pad_w else 0.0
    bias_col[-1, H - pad_h:] = -1e30 if pad_h else 0.0
    return f(B, L, E), f(B, L, E), f(B, W, E), f(B, H, E), f(B, H, W, E), bias_row, bias_col


@pytest.mark.parametrize("L,H,W,E,n,pad_w,pad_h", [
    (64, 6, 9, 32, 4, 0, 0),
    (100, 7, 7, 64, 8, 0, 0),
    (50, 8, 10, 32, 4, 3, 2),  # one image padded on the right and the bottom
])
def test_rank1_plain_matches_pallas_rank1(rng, L, H, W, E, n, pad_w, pad_h):
    args = rank1_inputs(rng, 2, L, H, W, E, pad_w, pad_h)
    got = rcda_rank1_core_plain(*map(t, args), n).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_rcda_rank1(*(jnp.asarray(a) for a in args), n, block_l=32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # in float32 the two formulations are one function
    np.testing.assert_allclose(got, rcda_core_plain(*map(t, args), n).numpy(), atol=ATOL, rtol=0)


def test_rank1_plain_rounds_only_the_product_in_bfloat16(rng):
    """bfloat16: P = a_col * a_row is rounded once, in f32 before the cast;
    the result is q's dtype and within bf16 noise of the two-stage core."""
    args = [t(a) for a in rank1_inputs(rng, 2, 30, 5, 6, 32, 2, 1)]
    bf = [a.to(torch.bfloat16) for a in args]
    got = rcda_rank1_core_plain(*bf, 4)
    assert got.dtype == torch.bfloat16
    B, L, E, n, d = 2, 30, 32, 4, 8
    qr, qc = bf[0].float().view(B, L, n, d), bf[1].float().view(B, L, n, d)
    a_row = torch.softmax(torch.einsum("blnd,bwnd->bnlw", qr, bf[2].float().view(B, 6, n, d))
                          + bf[5].float()[:, None, None], -1)
    a_col = torch.softmax(torch.einsum("blnd,bhnd->bnlh", qc, bf[3].float().view(B, 5, n, d))
                          + bf[6].float()[:, None, None], -1)
    p = (a_col[..., :, None] * a_row[..., None, :]).to(torch.bfloat16).float()
    want = torch.einsum("bnlhw,bhwnd->blnd", p, bf[4].float().view(B, 5, 6, n, d))
    torch.testing.assert_close(got, want.reshape(B, L, E).to(torch.bfloat16), rtol=0, atol=0)
    two_stage = rcda_core_plain(*bf, 4)
    assert (got.float() - two_stage.float()).abs().max() < 2e-2


@pytest.mark.parametrize("masked", [False, True])
def test_rank1_core_gradient_is_the_two_stage_gradient(rng, masked):
    args = rank1_inputs(rng, 2, 30, 6, 5, 16, 2 if masked else 0, 1 if masked else 0)
    cot = t(rng.normal(size=(2, 30, 16)))
    xs = [t(a).requires_grad_() for a in args[:5]]
    out = rcda_kernel.rcda_core(*xs, t(args[5]), t(args[6]), 4, "rank1")
    assert type(out.grad_fn).__name__ == "RCDACoreBackward"
    np.testing.assert_allclose(out.detach().numpy(),
                               rcda_rank1_core_plain(*map(t, args), 4).numpy(), atol=0, rtol=0)
    got = torch.autograd.grad(out, xs, cot)
    ys = [t(a).requires_grad_() for a in args[:5]]
    want = torch.autograd.grad(rcda_core_plain(*ys, t(args[5]), t(args[6]), 4), ys, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


def test_unknown_variant_raises(rng):
    args = [t(a) for a in rank1_inputs(rng, 1, 4, 3, 3, 16)]
    with pytest.raises(ValueError, match="variant"):
        rcda_kernel.rcda_core(*args, 4, "rank2")

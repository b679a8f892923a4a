"""The port's attention cores and attention functions against the JAX
package, on the CPU.

The plain cores (the CUDA kernels' oracles) are held against the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them, and against its einsum cores; the attention functions end to end
with grid queries and padding. float32, atol 2e-5 (the Pallas kernels sum
in another order and, for RCDA, weight by column before folding heads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from countdetr_tpu.ops import rcda as jrcda
from countdetr_tpu.ops.pallas.mha_kernel import fused_mha, mha_core_einsum
from countdetr_tpu.ops.pallas.rcda_kernel import fused_rcda

from countdetr_tpu_torch.ops import rcda as trcda
from countdetr_tpu_torch.ops.kernels.mha_kernel import mha_core_plain
from countdetr_tpu_torch.ops.kernels.rcda_kernel import rcda_core_plain

ATOL = 2e-5


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rcda_inputs(rng, B, L, H, W, E, masked):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    d = E // 4
    q_row, q_col = f(B, L, E) * d**-0.5, f(B, L, E) * d**-0.5
    k_row, k_col, v = f(B, W, E), f(B, H, E), f(B, H, W, E)
    bias_row = np.zeros((B, W), np.float32)
    bias_col = np.zeros((B, H), np.float32)
    if masked:
        bias_row[-1, W - 3:] = -1e30
        bias_col[-1, H - 2:] = -1e30
    return q_row, q_col, k_row, k_col, v, bias_row, bias_col


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L,H,W,E", [(64, 6, 9, 32), (50, 7, 5, 16)])
def test_rcda_core_plain_matches_pallas_and_einsum(rng, L, H, W, E, masked):
    args = rcda_inputs(rng, 2, L, H, W, E, masked)
    got = rcda_core_plain(*map(t, args), 4).numpy()
    jargs = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(fused_rcda(*jargs, 4, block_l=16))
    einsum = np.asarray(jrcda._rcda_core_einsum(*jargs, 4))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, einsum, atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [20, 40])
def test_mha_core_plain_matches_pallas_with_dead_row(rng, S):
    """Partly masked keys in one batch row, all keys masked in the other:
    finite, and the dead row is the uniform mean of v."""
    B, L, n, d = 2, 12, 2, 8
    q = rng.normal(size=(B, L, n * d)).astype(np.float32) * d**-0.5
    k = rng.normal(size=(B, S, n * d)).astype(np.float32)
    v = rng.normal(size=(B, S, n * d)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[0, S - 7:] = True
    mask[1, :] = True
    bias = np.where(mask, -1e30, 0.0).astype(np.float32)
    got = mha_core_plain(t(q), t(k), t(v), t(bias), n).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    pallas = np.asarray(fused_mha(*jargs, n, interpret=True))
    einsum = np.asarray(mha_core_einsum(*jargs, n))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, einsum, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape), atol=1e-6)


def rcda_params(rng, E):
    w = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    return w(5 * E, E), w(5 * E), w(E, E), w(E)


@pytest.mark.parametrize("grid", [True, False])
def test_rcda_attention_end_to_end(rng, grid):
    """Packed in-projection, masked axis-means, -1e30 biases, output
    projection; grid queries (the encoder) and flat queries (the decoder's
    cross-attention) against one padded image."""
    B, H, W, E, n, L = 2, 5, 7, 32, 4, 9
    params = rcda_params(rng, E)
    qshape = (B, H, W, E) if grid else (B, L, E)
    qr = rng.normal(size=qshape).astype(np.float32)
    qc = rng.normal(size=qshape).astype(np.float32)
    kr, kc, val = (rng.normal(size=(B, H, W, E)).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, H, W), bool)
    mask[1, 3:, :] = True
    mask[1, :, 5:] = True
    want = jrcda.rcda_attention(
        *(jnp.asarray(a) for a in (qr, qc, kr, kc, val)),
        jrcda.RCDAParams(*(jnp.asarray(p) for p in params)), n, jnp.asarray(mask))
    got = trcda.rcda_attention(*map(t, (qr, qc, kr, kc, val)), *map(t, params), n,
                               torch.from_numpy(mask))
    assert tuple(got.shape) == qshape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_mha_attention_end_to_end(rng, masked):
    B, L, E, n = 2, 10, 16, 2
    q, kv = (rng.normal(size=(B, L, E)).astype(np.float32) for _ in range(2))
    w = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    params = (w(3 * E, E), w(3 * E), w(E, E), w(E))
    mask = None
    if masked:
        mask = np.zeros((B, L), bool)
        mask[0, 7:] = True
        mask[1, :] = True
    want = jrcda.mha_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                               *(jnp.asarray(p) for p in params), n,
                               None if mask is None else jnp.asarray(mask))
    got = trcda.mha_attention(t(q), t(kv), t(kv), *map(t, params), n,
                              None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

"""The one-pass MHA kernel's arithmetic against the JAX package, on the CPU.

``csrc/mha.cu`` cannot run here, so ``mha_online`` writes its arithmetic
in torch, step for step: key tiles of 64 or 128 keys, keys past S at -inf,
logits q.k log2(e) + bias log2(e), a running row max from -FLT_MAX,
p = 2^(x - m) summed unrounded in f32, p rounded to v's dtype for the PV
product (f32 accumulation), the output rescaled by 2^(m_old - m_new) when
the max grows and divided by the f32 sum once at the end; a row whose keys
fit one tile is normalised before the rounding instead. That is held
against the JAX package's ``mha_core_einsum`` and its Pallas ``fused_mha``
(interpret mode), which round the normalised probabilities instead: within
1e-2 in bfloat16 and 1e-5 in float32. One image has part of its keys
masked, one all of them (the uniform softmax: the mean of v).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.ops.pallas.mha_kernel import fused_mha, mha_core_einsum

LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
B, L, E, HEADS = 3, 20, 64, 2
TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def mha_online(q, k, v, bias, num_heads, tile):
    """csrc/mha.cu's one-pass arithmetic in torch: (B, L, E) in q's dtype."""
    b, l, e = q.shape
    S = k.shape[1]
    d = e // num_heads

    def heads(x):
        return x.reshape(b, -1, num_heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q).float(), heads(k).float(), heads(v)
    m = torch.full((b, num_heads, l), -FLT_MAX)
    z = torch.zeros(b, num_heads, l)
    o = torch.zeros(b, num_heads, l, d)
    one_tile = S <= tile  # normalised before the rounding, no division at the end
    for t0 in range(0, S, tile):
        pad = max(0, t0 + tile - S)  # the last tile's keys past S: zero rows, bias -inf
        kt = torch.nn.functional.pad(kh[:, :, t0:t0 + tile], (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vh[:, :, t0:t0 + tile], (0, 0, 0, pad))
        bt = torch.nn.functional.pad(bias[:, t0:t0 + tile].float(), (0, pad),
                                     value=-float("inf"))
        x = torch.einsum("bnld,bntd->bnlt", qh, kt) * LOG2E + (bt * LOG2E)[:, None, None, :]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        z = z * alpha + p.sum(-1)
        if one_tile:
            p, z = p * (1.0 / z)[..., None], torch.ones_like(z)
        o = o * alpha[..., None] + torch.einsum("bnlt,bntd->bnld", p.to(v.dtype).float(),
                                                vt.float())
        m = m_new
    out = o / z[..., None]
    return out.permute(0, 2, 1, 3).reshape(b, l, e).to(q.dtype)


@functools.lru_cache(maxsize=None)
def case(S, dtype):
    """Inputs from a seed (float32 numpy), and the JAX package's two
    results in ``dtype``: the einsum core and the Pallas kernel."""
    rng = np.random.default_rng(S)
    d = E // HEADS
    q = rng.normal(size=(B, L, E)).astype(np.float32) * d**-0.5
    k = rng.normal(size=(B, S, E)).astype(np.float32)
    # values at half scale: outputs stay below 1, where a bf16 ulp is 2^-8
    # and the two rounding orders cannot drift two ulps apart
    v = rng.normal(size=(B, S, E)).astype(np.float32) * 0.5
    bias = np.zeros((B, S), np.float32)
    bias[1, S // 2 + 1:] = -1e30  # part of the keys masked
    bias[2, :] = -1e30  # every key masked
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = [jnp.asarray(x).astype(jdt) for x in (q, k, v)] + [jnp.asarray(bias)]
    einsum = np.asarray(mha_core_einsum(*jargs, HEADS).astype(jnp.float32))
    pallas = np.asarray(fused_mha(*jargs, HEADS, interpret=True).astype(jnp.float32))
    return (q, k, v, bias), einsum, pallas


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S", [23, 130, 576, 1700])
def test_one_pass_matches_jax(S, dtype, tile):
    (q, k, v, bias), einsum, pallas = case(S, dtype)
    tdt = getattr(torch, dtype)
    got = mha_online(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(bias),
                     HEADS, tile).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, einsum, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype], rtol=0)
    # the fully masked image: the uniform softmax, the mean of its values
    v_mean = torch.from_numpy(v[2]).to(tdt).float().mean(0).numpy()
    np.testing.assert_allclose(got[2], np.broadcast_to(v_mean, got[2].shape), atol=1e-2, rtol=0)

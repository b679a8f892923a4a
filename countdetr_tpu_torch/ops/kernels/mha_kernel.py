"""Multi-head attention core: a hand-written CUDA kernel and its plain version.

``mha_core`` is what every standard attention calls: the decoder's
self-attention, and under ``attention_type="MHA"`` the encoder's
self-attention and the decoder's cross-attention over the H*W pixels,
and the level layers (one batch row a pixel, 3 keys). On a CUDA tensor
it launches the kernel in ``csrc/mha.cu`` (the counterpart of the JAX
package's Pallas ``fused_mha``); on a CPU tensor it runs ``mha_core_plain``.
There is no fallback between the two: a CUDA call that the kernel cannot
take raises. Each call is a ``core.mha`` span and each launch counts
``launch.mha`` (``utils/trace.py``).

q (B, L, E) pre-scaled by d**-0.5, k and v (B, S, E) in one dtype, bias
(B, S) float32 additive (0 valid / -1e30 padded). Returns (B, L, E) in q's
dtype. A row whose keys are all masked gets the uniform softmax.

Float32 (the CLI's default ``--compute_dtype``) runs every product as three
TF32 products on the tensor cores (3xTF32: f32 accuracy, within 1e-4 of
the plain version).

Key lengths: the kernels make one pass over the keys with an online
softmax and keep no row of logits, so they take every key length (every
stage-1 point tier included). Batches: any (the batch rides on the grid's
x dimension with the query tiles). The bfloat16 kernel rounds the
unnormalised probabilities to bf16 and divides by their f32 sum at the
end, where the plain version rounds the normalised ones; a row whose keys
fit one 64-key tile it normalises first too. Each output is within
max(1e-2, one bf16 ulp of the plain output).

Where a gradient is wanted, the core runs inside ``MHACore``, an autograd
Function whose backward recomputes through the plain core (the JAX
package's ``mha_core_fused`` backward); the bias gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from countdetr_tpu_torch.ops.kernels import _build
from countdetr_tpu_torch.utils import trace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)


def mha_core_plain(q, k, v, bias, num_heads):
    """Plain PyTorch core, the JAX package's ``mha_core_einsum``: f32 logits
    plus the f32 key bias, f32 softmax, probabilities cast to v's dtype."""
    B, L, E = q.shape
    d = E // num_heads
    qh = q.reshape(B, L, num_heads, d).float()
    kh = k.reshape(B, -1, num_heads, d).float()
    vh = v.reshape(B, -1, num_heads, d)
    attn = torch.einsum("blnd,bsnd->bnls", qh, kh) + bias.float()[:, None, None, :]
    p = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("bnls,bsnd->blnd", p, vh).reshape(B, L, E)


def _lib() -> ctypes.CDLL:
    lib = _build.load("mha")
    if lib.mha_forward.argtypes is None:
        lib.mha_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        lib.mha_forward.restype = ctypes.c_int
    return lib


def _check(q, k, v, bias, num_heads):
    for name, t in dict(q=q, k=k, v=v, bias=bias).items():
        if t.device != q.device:
            raise ValueError(f"mha: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"mha: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"mha: {name} is not 16-byte aligned")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         "must match, float32 or bfloat16")
    if bias.dtype != torch.float32:
        raise ValueError(f"mha: bias must be float32, got {bias.dtype}")
    if q.dim() != 3:
        raise ValueError(f"mha: q has shape {tuple(q.shape)}, want (B, L, E)")
    B, L, E = q.shape
    S = k.shape[1] if k.dim() == 3 else -1
    for name, t, shape in (("k", k, (B, S, E)), ("v", v, (B, S, E)), ("bias", bias, (B, S))):
        if tuple(t.shape) != shape:
            raise ValueError(f"mha: {name} has shape {tuple(t.shape)}, want {shape}")
    if E % num_heads or E // num_heads not in HEAD_DIMS:
        raise ValueError(f"mha: head dim {E}/{num_heads} not in {HEAD_DIMS}")
    if S < 1:
        raise ValueError("mha: no keys")


def _mha_forward(q, k, v, bias, num_heads):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return mha_core_plain(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha: no kernel for device {q.device}")
    _check(q, k, v, bias, num_heads)
    B, L, E = q.shape
    S = k.shape[1]
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mha_forward(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, L, S, E, num_heads, stream,
    )
    if err != 0:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {err}")
    trace.count("launch.mha")
    return out


class MHACore(torch.autograd.Function):
    """Forward: ``_mha_forward``. Backward: ``torch.autograd.grad`` of the
    plain core, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, bias)
        return _mha_forward(q, k, v, bias, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        *xs, bias = ctx.saved_tensors
        xs = [x.detach().requires_grad_(need) for x, need in zip(xs, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = mha_core_plain(*xs, bias, ctx.num_heads)
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if x.requires_grad else None for x in xs]
        return (*grads, None, None)


def mha_core(q, k, v, bias, num_heads):
    """The attention core: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in q, k and v."""
    with trace.span("core.mha", lambda: f"B={q.shape[0]} L={q.shape[1]} S={k.shape[1]} "
                                        f"{str(q.dtype).removeprefix('torch.')}"):
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return MHACore.apply(q, k, v, bias, num_heads)
        return _mha_forward(q, k, v, bias, num_heads)

"""The RCDA attention core: a hand-written CUDA kernel and its plain version.

``rcda_core`` is what the model calls. On a CUDA tensor it launches the
kernel in ``csrc/rcda.cu`` (the counterpart of the JAX package's Pallas
``fused_rcda``); on a CPU tensor it runs ``rcda_core_plain``. There is no
fallback between the two: a CUDA call that the kernel cannot take raises.

Inputs are the projected tensors, exactly what ``ops/rcda.py`` computes:
  q_row, q_col : (B, L, E), pre-scaled by d**-0.5
  k_row        : (B, W, E) axis-meaned key rows
  k_col        : (B, H, E)
  v            : (B, H, W, E)
  bias_row     : (B, W) additive mask, 0 valid / -1e30 padded, q's dtype
  bias_col     : (B, H)
Returns (B, L, E) in q's dtype.

Where a gradient is wanted, the core runs inside ``RCDACore``, an autograd
Function whose backward recomputes through the plain core (the JAX
package's ``_rcda_pallas_bwd``): only the inputs are saved, no
(B, n, L, H, d) intermediate. The biases get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from countdetr_tpu_torch.ops.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
MAX_AXIS_BF16 = 64  # the tensor-core path holds a_row for W <= 64 in registers

# Kernel launches since the counter was last reset (by whoever reads it).
launches = 0


def rcda_core_plain(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """Plain PyTorch RCDA core, the JAX package's ``_rcda_core_einsum``:
    f32 scores and softmaxes, both probability maps cast to v's dtype, then
    the two-stage combine ``sum_h a_col[l,h] sum_w a_row[l,w] v[h,w]``."""
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    d = E // num_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], num_heads, d)

    qr, qc = heads(q_row).float(), heads(q_col).float()
    kr, kc = heads(k_row).float(), heads(k_col).float()
    vh = heads(v)
    attn_row = torch.einsum("blnd,bwnd->bnlw", qr, kr) + bias_row.float()[:, None, None, :]
    attn_col = torch.einsum("blnd,bhnd->bnlh", qc, kc) + bias_col.float()[:, None, None, :]
    attn_row = torch.softmax(attn_row, dim=-1).to(v.dtype)
    attn_col = torch.softmax(attn_col, dim=-1).to(v.dtype)
    hid = torch.einsum("bnlw,bhwnd->bnlhd", attn_row, vh)
    out = torch.einsum("bnlh,bnlhd->blnd", attn_col, hid)
    return out.reshape(B, L, E)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rcda")
    if lib.rcda_forward.argtypes is None:
        lib.rcda_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        lib.rcda_forward.restype = ctypes.c_int
        lib.rcda_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.rcda_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    tensors = dict(q_row=q_row, q_col=q_col, k_row=k_row, k_col=k_col, v=v,
                   bias_row=bias_row, bias_col=bias_col)
    for name, t in tensors.items():
        if t.device != q_row.device:
            raise ValueError(f"rcda: {name} is on {t.device}, q_row on {q_row.device}")
        if t.dtype != q_row.dtype:
            raise ValueError(f"rcda: {name} is {t.dtype}, q_row is {q_row.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rcda: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"rcda: {name} is not 16-byte aligned")
    if q_row.dtype not in DTYPE_CODES:
        raise ValueError(f"rcda: dtype {q_row.dtype} not supported (float32, bfloat16)")
    if q_row.dim() != 3 or v.dim() != 4:
        raise ValueError(f"rcda: q_row {tuple(q_row.shape)} / v {tuple(v.shape)} ranks")
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    want = dict(q_col=(B, L, E), k_row=(B, W, E), k_col=(B, H, E), v=(B, H, W, E),
                bias_row=(B, W), bias_col=(B, H))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"rcda: {name} has shape {tuple(tensors[name].shape)}, want {shape}")
    if E % num_heads or E // num_heads not in HEAD_DIMS:
        raise ValueError(f"rcda: head dim {E}/{num_heads} not in {HEAD_DIMS}")
    if q_row.dtype == torch.bfloat16 and max(H, W) > MAX_AXIS_BF16:
        raise ValueError(f"rcda: bfloat16 kernel takes H, W <= {MAX_AXIS_BF16}, got {H}, {W}")


def _rcda_forward(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if q_row.device.type == "cpu":
        return rcda_core_plain(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)
    if q_row.device.type != "cuda":
        raise ValueError(f"rcda: no kernel for device {q_row.device}")
    _check(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    lib = _lib()
    smem = lib.rcda_smem_bytes(DTYPE_CODES[q_row.dtype], E // num_heads, H, W)
    if smem > 232448:
        raise ValueError(f"rcda: H={H}, W={W} need {smem} B of shared memory per block")
    out = torch.empty_like(q_row)
    stream = torch.cuda.current_stream(q_row.device).cuda_stream
    err = lib.rcda_forward(
        DTYPE_CODES[q_row.dtype],
        q_row.data_ptr(), q_col.data_ptr(), k_row.data_ptr(), k_col.data_ptr(),
        v.data_ptr(), bias_row.data_ptr(), bias_col.data_ptr(), out.data_ptr(),
        B, L, H, W, E, num_heads, stream,
    )
    if err != 0:
        raise RuntimeError(f"rcda kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class RCDACore(torch.autograd.Function):
    """Forward: ``_rcda_forward``. Backward: ``torch.autograd.grad`` of the
    plain core, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q_row, q_col, k_row, k_col, v, bias_row, bias_col)
        return _rcda_forward(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        *xs, bias_row, bias_col = ctx.saved_tensors
        xs = [x.detach().requires_grad_(need) for x, need in zip(xs, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = rcda_core_plain(*xs, bias_row, bias_col, ctx.num_heads)
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if x.requires_grad else None for x in xs]
        return (*grads, None, None, None)


def rcda_core(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """The RCDA core: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; differentiable in q_row, q_col, k_row, k_col and v."""
    args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args[:5]):
        return RCDACore.apply(*args)
    return _rcda_forward(*args)

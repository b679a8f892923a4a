"""The RCDA attention core: two hand-written CUDA kernels and their plain
versions, one pair per variant.

``rcda_core`` is what the model calls; ``variant`` picks the formulation
(``ModelConfig.rcda_variant``, the JAX package's COUNTDETR_PALLAS_VARIANT):
  "v3"    the two-stage combine: ``csrc/rcda.cu`` (the counterpart of the
          JAX package's Pallas ``fused_rcda``) and ``rcda_core_plain``;
  "rank1" one contraction over H*W of the rank-1 probabilities:
          ``csrc/rcda_rank1.cu`` (``fused_rcda_rank1``) and
          ``rcda_rank1_core_plain``.
On a CUDA tensor it launches a kernel (``kernel_route``); on a CPU tensor it
runs the variant's plain version. The two formulations differ only in where
they round to v's dtype (v3 each probability map, rank-1 the product P
once); in float32 both roundings are the identity and they are one function
up to the order of an f32 sum. So every float32 call, of either variant,
takes ``csrc/rcda.cu``: three TF32 products per product on the tensor cores
(3xTF32) where ``f32_route`` allows, else its CUDA-core kernel. A bfloat16
call takes its variant's kernel. There is no fallback between kernels: a
CUDA call that the chosen kernel cannot take raises. Each call is a
``core.rcda`` (``core.rcda_rank1``) span and each launch counts
``launch.rcda`` (``launch.rcda_rank1``) by the variant asked for, whichever
source ran; a float32 launch adds to ``launch.rcda_cuda_cores`` 1 where it
takes the CUDA cores and 0 where it takes the tensor cores
(``utils/trace.py``).

Inputs are the projected tensors, exactly what ``ops/rcda.py`` computes:
  q_row, q_col : (B, L, E), pre-scaled by d**-0.5
  k_row        : (B, W, E) axis-meaned key rows
  k_col        : (B, H, E)
  v            : (B, H, W, E)
  bias_row     : (B, W) additive mask, 0 valid / -1e30 padded, q's dtype
  bias_col     : (B, H)
Returns (B, L, E) in q's dtype.

Where a gradient is wanted, the core runs inside ``RCDACore``, an autograd
Function whose backward recomputes through the two-stage plain core for
either variant (the JAX package's ``_rcda_pallas_bwd``): only the inputs
are saved, no (B, n, L, H, d) intermediate. The biases get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from countdetr_tpu_torch.config import RCDA_VARIANTS
from countdetr_tpu_torch.ops.kernels import _build
from countdetr_tpu_torch.utils import trace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
F32_TENSOR_CORES = 2  # csrc/rcda.cu's code for float32 on the tensor cores
HEAD_DIMS = (16, 32, 64)
# H, W limit of the tensor-core paths (a_row held in registers): the bf16
# kernels of both variants and rcda.cu's 3xTF32 kernel
MAX_AXIS = 64


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


def rcda_rank1_core_plain(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads):
    """Plain PyTorch rank-1 RCDA core, the math of the JAX package's
    ``_rcda_rank1_kernel``: f32 scores and softmaxes, neither rounded;
    P[l, h, w] = a_col[l, h] * a_row[l, w] in f32, then cast to v's dtype;
    one contraction over H*W with f32 accumulation, cast to q's dtype.
    (``rcda_core_plain`` instead rounds each probability map to v's dtype
    on its own.)"""
    B, L, E = q_row.shape
    d = E // num_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], num_heads, d)

    qr, qc = heads(q_row).float(), heads(q_col).float()
    kr, kc = heads(k_row).float(), heads(k_col).float()
    attn_row = torch.einsum("blnd,bwnd->bnlw", qr, kr) + bias_row.float()[:, None, None, :]
    attn_col = torch.einsum("blnd,bhnd->bnlh", qc, kc) + bias_col.float()[:, None, None, :]
    attn_row = torch.softmax(attn_row, dim=-1)
    attn_col = torch.softmax(attn_col, dim=-1)
    p = (attn_col[..., :, None] * attn_row[..., None, :]).to(v.dtype)  # (B, n, L, H, W)
    out = torch.einsum("bnlhw,bhwnd->blnd", p.float(), heads(v).float())
    return out.reshape(B, L, E).to(q_row.dtype)


def f32_route(H, W, d):
    """csrc/rcda.cu's float32 kernel (either variant) for an H x W grid at
    head dim d: "tensor_cores" (3xTF32 on wgmma; one 64-wide score tile, so
    H, W <= MAX_AXIS, and a row of q or k in one 128-byte swizzle span, so
    d <= 32) or "cuda_cores"."""
    return "tensor_cores" if max(H, W) <= MAX_AXIS and d <= 32 else "cuda_cores"


PLAIN = {"v3": rcda_core_plain, "rank1": rcda_rank1_core_plain}
# the bf16 kernel of each variant; float32 calls of both take "rcda"
SOURCES = {"v3": "rcda", "rank1": "rcda_rank1"}


def kernel_route(variant, dtype, H, W, d):
    """(source, code) of the kernel that takes a CUDA call: the csrc/ file
    and its C entry's dtype code. float32, either variant: ``rcda`` on the
    tensor cores (``F32_TENSOR_CORES``) where ``f32_route`` allows, else on
    its CUDA cores (0). bfloat16: the variant's own kernel (1), which takes
    H, W <= MAX_AXIS. Raises ValueError where no kernel takes the call."""
    if dtype == torch.float32:
        tensor_cores = f32_route(H, W, d) == "tensor_cores"
        return "rcda", F32_TENSOR_CORES if tensor_cores else DTYPE_CODES[dtype]
    if dtype != torch.bfloat16:
        raise ValueError(f"rcda: dtype {dtype} not supported (float32, bfloat16)")
    if max(H, W) > MAX_AXIS:
        raise ValueError(f"rcda: the {variant} bfloat16 kernel takes H, W <= {MAX_AXIS}, "
                         f"got {H}, {W}")
    return SOURCES[variant], DTYPE_CODES[dtype]


def _lib(source: str):
    """The (forward, smem_bytes) C entry points of csrc/<source>.cu."""
    lib = _build.load(source)
    fwd, smem = getattr(lib, f"{source}_forward"), getattr(lib, f"{source}_smem_bytes")
    if fwd.argtypes is None:
        fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        fwd.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_longlong
    return fwd, smem


def _check(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads, variant):
    """Raise ValueError unless a kernel takes the call; return
    ``kernel_route``'s (source, code)."""
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
    return kernel_route(variant, q_row.dtype, H, W, E // num_heads)


def _rcda_forward(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads,
                  variant="v3"):
    """``kernel_route``'s kernel for CUDA tensors, the variant's plain
    version for CPU tensors."""
    if variant not in RCDA_VARIANTS:
        raise ValueError(f"rcda: variant must be one of {RCDA_VARIANTS}, got {variant!r}")
    if q_row.device.type == "cpu":
        return PLAIN[variant](q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)
    if q_row.device.type != "cuda":
        raise ValueError(f"rcda: no kernel for device {q_row.device}")
    source, code = _check(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads,
                          variant)
    B, L, E = q_row.shape
    H, W = v.shape[1], v.shape[2]
    forward, smem_bytes = _lib(source)
    smem = smem_bytes(code, E // num_heads, H, W)
    if smem > 232448:
        raise ValueError(f"rcda: H={H}, W={W} need {smem} B of shared memory per block")
    out = torch.empty_like(q_row)
    stream = torch.cuda.current_stream(q_row.device).cuda_stream
    err = forward(
        code,
        q_row.data_ptr(), q_col.data_ptr(), k_row.data_ptr(), k_col.data_ptr(),
        v.data_ptr(), bias_row.data_ptr(), bias_col.data_ptr(), out.data_ptr(),
        B, L, H, W, E, num_heads, stream,
    )
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")
    trace.count("launch.rcda_rank1" if variant == "rank1" else "launch.rcda")
    if q_row.dtype == torch.float32:  # 0 on the tensor cores: the counter exists
        trace.count("launch.rcda_cuda_cores", int(code != F32_TENSOR_CORES))
    return out


class RCDACore(torch.autograd.Function):
    """Forward: ``_rcda_forward`` of the variant. Backward:
    ``torch.autograd.grad`` of the two-stage plain core, recomputed from the
    saved inputs, for either variant."""

    @staticmethod
    def forward(ctx, q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads,
                variant="v3"):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q_row, q_col, k_row, k_col, v, bias_row, bias_col)
        return _rcda_forward(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads,
                             variant)

    @staticmethod
    def backward(ctx, grad_out):
        *xs, bias_row, bias_col = ctx.saved_tensors
        xs = [x.detach().requires_grad_(need) for x, need in zip(xs, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = rcda_core_plain(*xs, bias_row, bias_col, ctx.num_heads)
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if x.requires_grad else None for x in xs]
        return (*grads, None, None, None, None)


def rcda_core(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads, variant="v3"):
    """The RCDA core of ``variant``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; differentiable in q_row, q_col, k_row,
    k_col and v."""
    args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads, variant)
    name = "core.rcda_rank1" if variant == "rank1" else "core.rcda"
    with trace.span(name, lambda: _shape(q_row, v)):
        if torch.is_grad_enabled() and any(x.requires_grad for x in args[:5]):
            return RCDACore.apply(*args)
        return _rcda_forward(*args)


def _shape(q_row, v) -> str:
    """A span's shape: 'B=32 L=1369 37x37 float32'."""
    (B, L, _), (H, W) = q_row.shape, v.shape[1:3]
    return f"B={B} L={L} {H}x{W} {str(q_row.dtype).removeprefix('torch.')}"

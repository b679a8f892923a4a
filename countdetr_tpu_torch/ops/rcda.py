"""Row-Column Decoupled Attention and multi-head attention around their
cores (countdetr_tpu/ops/rcda.py; reference
models/row_column_decoupled_attention.py:23-272).

RCDA: one packed (5E, E) input projection [q_row; q_col; k_row; k_col; v];
projected keys are axis-averaged over the valid rows/columns only; two 1-D
attentions per head; out[q] = sum_h sum_w A_col[q,h] A_row[q,w] v[h,w];
one (E, E) output projection. The cores run the CUDA kernel for CUDA
tensors and the plain version for CPU tensors (ops/kernels/); ``variant``
picks the RCDA core's formulation, "v3" (two-stage) or "rank1".

Layouts are the JAX package's: (B, L, E) queries or (B, H, W, E) grid
queries, (B, H, W, E) keys and values, (B, H, W) padding masks (True = pad).
The projections may be narrower than E: under tensor parallelism a rank's
packed weights hold its ``num_heads`` heads of each role, (5E/M, E) and
(3E/M, E), and ``out_proj_weight`` their (E, E/M) columns; the head dim is
the projections' width over ``num_heads``, and the output is E wide, a
partial sum the caller reduces (``out_proj_bias`` None leaves the bias to
it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from countdetr_tpu_torch.ops.kernels.mha_kernel import mha_core
from countdetr_tpu_torch.ops.kernels.rcda_kernel import rcda_core


def rcda_attention(
    query_row: torch.Tensor,  # (B, L, E), or (B, H, W, E) grid queries
    query_col: torch.Tensor,  # same shape as query_row
    key_row: torch.Tensor,  # (B, H, W, E)
    key_col: torch.Tensor,  # (B, H, W, E)
    value: torch.Tensor,  # (B, H, W, E)
    in_proj_weight: torch.Tensor,  # (5E', E), E' = E or a rank's E/M
    in_proj_bias: torch.Tensor,  # (5E',)
    out_proj_weight: torch.Tensor,  # (E, E')
    out_proj_bias: Optional[torch.Tensor],  # (E,) or None
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, H, W) True = pad
    variant: str = "v3",
) -> torch.Tensor:
    """Returns (B, L, E) for flat queries, (B, H, W, E) for grid queries,
    which are flattened to (B, H*W, E) at the core's boundary."""
    grid_shape = query_row.shape if query_row.dim() == 4 else None
    B, E = query_row.shape[0], query_row.shape[-1]
    H, W = key_row.shape[1], key_row.shape[2]
    d = in_proj_weight.shape[0] // 5 // num_heads
    query_row = query_row.reshape(B, -1, E)
    query_col = query_col.reshape(B, -1, E)

    wq_r, wq_c, wk_r, wk_c, wv = in_proj_weight.chunk(5)
    bq_r, bq_c, bk_r, bk_c, bv = in_proj_bias.chunk(5)
    q_row = F.linear(query_row, wq_r, bq_r)
    q_col = F.linear(query_col, wq_c, bq_c)
    k_row_full = F.linear(key_row, wk_r, bk_r)  # (B, H, W, E)
    k_col_full = F.linear(key_col, wk_c, bk_c)
    if key_padding_mask is None:
        k_row = k_row_full.mean(dim=1)  # (B, W, E)
        k_col = k_col_full.mean(dim=2)  # (B, H, E)
    else:
        # the means see only valid rows/columns, or padding would leak
        # into every key
        valid_h = (~key_padding_mask[:, :, 0]).to(k_row_full.dtype)  # (B, H)
        valid_w = (~key_padding_mask[:, 0, :]).to(k_row_full.dtype)  # (B, W)
        nh = valid_h.sum(1).clamp(min=1.0)[:, None, None]
        nw = valid_w.sum(1).clamp(min=1.0)[:, None, None]
        k_row = (k_row_full * valid_h[:, :, None, None]).sum(dim=1) / nh
        k_col = (k_col_full * valid_w[:, None, :, None]).sum(dim=2) / nw
    v = F.linear(value, wv, bv)

    q_row = q_row * d**-0.5
    q_col = q_col * d**-0.5
    if key_padding_mask is not None:
        neg = torch.tensor(-1e30, dtype=torch.float32, device=q_row.device)
        zero = torch.zeros((), dtype=torch.float32, device=q_row.device)
        bias_row = torch.where(key_padding_mask[:, 0, :], neg, zero).to(q_row.dtype)
        bias_col = torch.where(key_padding_mask[:, :, 0], neg, zero).to(q_row.dtype)
    else:
        bias_row = q_row.new_zeros((B, W))
        bias_col = q_row.new_zeros((B, H))

    out = rcda_core(
        q_row.contiguous(), q_col.contiguous(), k_row.contiguous(),
        k_col.contiguous(), v.contiguous(), bias_row, bias_col, num_heads, variant,
    )
    out = F.linear(out, out_proj_weight, out_proj_bias)
    return out.reshape(grid_shape) if grid_shape is not None else out


def mha_attention(
    query: torch.Tensor,  # (B, L, E)
    key: torch.Tensor,  # (B, S, E)
    value: torch.Tensor,  # (B, S, E)
    in_proj_weight: torch.Tensor,  # (3E', E) packed q, k, v; E' = E or E/M
    in_proj_bias: torch.Tensor,  # (3E',)
    out_proj_weight: torch.Tensor,  # (E, E')
    out_proj_bias: Optional[torch.Tensor],  # (E,) or None
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
) -> torch.Tensor:
    """Multi-head attention with nn.MultiheadAttention's packed weights (the
    decoder's query self-attention). The key bias is finite (-1e30) and
    float32, so a row whose keys are all masked gets a uniform softmax."""
    B = query.shape[0]
    d = in_proj_weight.shape[0] // 3 // num_heads
    wq, wk, wv = in_proj_weight.chunk(3)
    bq, bk, bv = in_proj_bias.chunk(3)
    q = F.linear(query, wq, bq) * d**-0.5
    k = F.linear(key, wk, bk)
    v = F.linear(value, wv, bv)
    S = k.shape[1]
    if key_padding_mask is not None:
        bias = torch.where(
            key_padding_mask,
            torch.tensor(-1e30, dtype=torch.float32, device=q.device),
            torch.zeros((), dtype=torch.float32, device=q.device),
        )
    else:
        bias = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    out = mha_core(q.contiguous(), k.contiguous(), v.contiguous(), bias, num_heads)
    return F.linear(out, out_proj_weight, out_proj_bias)

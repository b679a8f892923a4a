"""Batched assignment of queries to targets (countdetr_tpu/ops/matching.py).

The reference matches each image with scipy's ``linear_sum_assignment`` on
the host (2nd-stage matcher.py:243-246). Here the default is a Jacobi
forward auction on the device (``ops/kernels/auction_kernel.py``), one
problem per image, with no host round trip; ``exact_batched_match`` keeps
the host scipy route.

Costs are (B, Q, T), the reference's (num_queries, num_targets) layout.
When T <= Q every valid target bids for a distinct query. When T > Q the
auction is transposed: all Q queries bid over the T targets, invalid
targets being uniformly bad dummy objects, so exactly min(Q, #valid)
targets win a query (the rectangular LAP the reference solves), and
``matched`` marks them. The result is within T * eps of the optimum, with
eps = span / 1000 per image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from countdetr_tpu_torch.ops.kernels.auction_kernel import SCALE_START, auction_assign


def dummy_rows_unit(n_dummy: int, n_obj: int, device=None) -> torch.Tensor:
    """Deterministic noise in [0, 1), (n_dummy, n_obj), for the square
    reduction's dummy bidder rows (callers scale it by eps / 2): a
    multiplicative hash of (row, col) in uint32 arithmetic, so no two dummy
    rows share their argmax and serialise the auction."""
    mask = 0xFFFFFFFF
    di = torch.arange(n_dummy, dtype=torch.int64, device=device)[:, None]
    dj = torch.arange(n_obj, dtype=torch.int64, device=device)[None, :]
    h = ((di * 2654435761) & mask) + ((dj * 2246822519) & mask)
    h = ((h & mask) >> 12) & 0xFFFFF
    return h.to(torch.float32) * (1.0 / float(1 << 20))


def auction_inputs(cost: torch.Tensor, tgt_valid: torch.Tensor, eps_frac: float = 1e-3,
                   scaling: bool = False):
    """The auction ``batched_match`` solves for a (B, Q, T) float32 cost:
    (benefit (B, P, O), active (B, P), eps (B,), max_iters, scaling).
    T <= Q: the targets bid for queries, benefit -cost^T (0 on invalid
    rows, which are inactive). T > Q: the Q queries bid for targets,
    benefit -cost with -big on invalid targets, big = (span + eps) (Q + 2)
    being above any price the auction can reach; with ``scaling``, T - Q
    dummy bidder rows make the problem square."""
    B, Q, T = cost.shape
    span = (cost.amax(dim=(1, 2)) - cost.amin(dim=(1, 2))).clamp(min=1e-3)
    eps = span * eps_frac
    iters_cap = 16 * T + 2048
    if T <= Q:
        benefit = torch.where(tgt_valid[:, :, None], -cost.transpose(1, 2), 0.0)
        return benefit.contiguous(), tgt_valid, eps, iters_cap, False
    squared = scaling
    big = (span + eps * (SCALE_START if squared else 1.0)) * ((T if squared else Q) + 2)
    benefit = torch.where(tgt_valid[:, None, :], -cost, -big[:, None, None])
    if squared:
        dummies = dummy_rows_unit(T - Q, T, cost.device)[None] * (eps[:, None, None] * 0.5)
        benefit = torch.cat([benefit, dummies], dim=1)  # (B, T, T)
    active = torch.ones(benefit.shape[:2], dtype=torch.bool, device=cost.device)
    return benefit.contiguous(), active, eps, iters_cap, squared


def batched_match(
    cost: torch.Tensor,  # (B, Q, T)
    tgt_valid: torch.Tensor,  # (B, T) bool
    eps_frac: float = 1e-3,
    scaling: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tgt2query (B, T) int64, matched (B, T) bool); matched equals
    tgt_valid when T <= Q and is a subset of it otherwise.

    The solve is always float32: eps = span / 1000 is below bfloat16's
    resolution, so a bf16 auction could cycle to its cap. ``scaling`` runs
    the T > Q case as a square problem with eps-scaling phases; off by
    default, as in the JAX package, where it measured slower on most cost
    structures."""
    cost = cost.float()
    B, Q, T = cost.shape
    benefit, active, eps, iters_cap, squared = auction_inputs(cost, tgt_valid, eps_frac, scaling)
    assigned = auction_assign(benefit, active, eps, iters_cap, scaling=squared)
    if T <= Q:
        return torch.where(tgt_valid, assigned.clamp(min=0), 0), tgt_valid

    # q_of_t[t] = the query that won target t; unassigned queries land in T
    slot = torch.where(assigned[:, :Q] >= 0, assigned[:, :Q], T)
    queries = torch.arange(Q, device=cost.device).expand(B, Q)
    q_of_t = torch.full((B, T + 1), -1, dtype=torch.long, device=cost.device)
    q_of_t = q_of_t.scatter_reduce(1, slot, queries, "amax")[:, :T]
    matched = (q_of_t >= 0) & tgt_valid
    return torch.where(matched, q_of_t.clamp(min=0), 0), matched


def scipy_match(cost, tgt_valid) -> Tuple[np.ndarray, np.ndarray]:
    """Exact LAP per image on the host, as the reference does
    (matcher.py:243-246); rectangular costs give min(Q, #valid) optimal
    pairs. numpy in, numpy out: (tgt2query (B, T) int32, matched (B, T))."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost)
    tgt_valid = np.asarray(tgt_valid)
    B, Q, T = cost.shape
    out = np.zeros((B, T), dtype=np.int32)
    matched = np.zeros((B, T), dtype=bool)
    for b in range(B):
        t_idx = np.nonzero(tgt_valid[b])[0]
        if len(t_idx) == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b][:, t_idx])
        out[b, t_idx[cols]] = rows.astype(np.int32)
        matched[b, t_idx[cols]] = True
    return out, matched


def exact_batched_match(cost: torch.Tensor, tgt_valid: torch.Tensor):
    """``scipy_match`` on the host for tensors on any device (the
    exact_match route): one device-to-host copy and a sync per call, so it
    is not for the performance path."""
    tq, m = scipy_match(cost.detach().float().cpu().numpy(), tgt_valid.cpu().numpy())
    return (torch.from_numpy(tq).long().to(cost.device),
            torch.from_numpy(m).to(cost.device))

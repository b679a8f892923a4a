"""The matcher's auction: a hand-written CUDA kernel and its plain version.

``auction_assign`` is what ``ops/matching.py`` calls. On a CUDA tensor it
launches the kernel in ``csrc/auction.cu`` (the counterpart of the JAX
package's Pallas ``auction_assign``); on a CPU tensor it runs
``auction_plain``. There is no fallback between the two: a CUDA call that
the kernel cannot take raises. Each call is a ``core.auction`` span and each
launch counts ``launch.auction`` (``utils/trace.py``). The kernel runs
each image on a cluster of C thread blocks; ``cluster_plan`` picks C and
whether the image's benefit rows stay resident in the cluster's shared
memory or stream from L2.

A batched Jacobi (all bidders at once) forward auction, one problem per
image (countdetr_tpu/ops/matching.py::_auction):
  benefit (B, P, O) float32: value of object o for person p;
  active (B, P) bool: persons that must be assigned;
  eps (B,) float32: the final bidding increment;
returns assigned (B, P) int64, the object per person (-1 only where
``max_iters`` rounds ran out), and with ``with_stats=True`` also, per image,
the rounds run and the bids made over all rounds (the benefit rows read),
each (B,) int64. ``scaling`` runs the eps-scaling phases (start at
SCALE_START * eps, divide by SCALE_THETA each time everyone is assigned,
keep the prices); it is sound only on square problems with every person
active (ops/matching.py's square reduction).
"""

from __future__ import annotations

import ctypes

import torch

from countdetr_tpu_torch.ops.kernels import _build
from countdetr_tpu_torch.utils import trace

NEG_INF = -1e30
SCALE_START = 512.0
SCALE_THETA = 8.0
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
# Thread blocks a cluster (one image): of 4, 8 and 16, 16 ran the 8x576x700
# matcher batches fastest on an H100 (chip_smoke.py's cluster sweep; PERF.md).
# 16 is the largest cluster the card schedules, beyond the portable 8: the
# kernel sets the non-portable cluster attribute for it.
CLUSTER = 16
MAX_CLUSTER = 16


def auction_plain(benefit, active, eps, max_iters, scaling=False, with_stats=False):
    """Plain PyTorch auction, the dense round body of the JAX package's
    ``_auction`` with the batch written out: images that are done keep their
    state while the others go on. Argmaxes are min-index-over-maxima, the
    bid is ``prices[q1] + ((v1 - v2) + eps)`` in float32, in that order."""
    B, P, O = benefit.shape
    dev = benefit.device
    f32 = torch.float32
    benefit = benefit.to(f32)
    active = active.bool()
    neg_inf = torch.tensor(NEG_INF, dtype=f32, device=dev)
    half_neg_inf = torch.tensor(NEG_INF / 2, dtype=f32, device=dev)
    iota_o = torch.arange(O, device=dev)
    iota_p = torch.arange(P, device=dev).expand(B, P)
    eps_fin = eps.to(f32)
    eps_stop = eps_fin * 1.5
    cur_eps = eps_fin * SCALE_START if scaling else eps_fin.clone()
    owner0 = torch.full((B, O), -1, dtype=torch.long, device=dev)
    assigned0 = torch.where(active, -1, 0).long()
    owner, assigned = owner0.clone(), assigned0.clone()
    prices = torch.zeros((B, O), dtype=f32, device=dev)
    rounds = torch.zeros(B, dtype=torch.long, device=dev)
    bids = torch.zeros(B, dtype=torch.long, device=dev)

    def open_persons(a):
        return ((a < 0) & active).any(1)

    def still_running(a, e):
        return (rounds < max_iters) & ~(~open_persons(a) & (e <= eps_stop))

    running = still_running(assigned, cur_eps)
    while P and O and bool(running.any()):
        unassigned = (assigned < 0) & active
        values = benefit - prices[:, None, :]
        v1 = values.amax(2)
        q1 = torch.where(values >= v1[..., None], iota_o, O).amin(2)
        v2 = values.masked_fill(iota_o == q1[..., None], NEG_INF).amax(2)
        v2 = torch.where(v2 > half_neg_inf, v2, v1 - 1.0)  # O == 1
        incr = v1 - v2 + cur_eps[:, None]
        bid = torch.where(unassigned, prices.gather(1, q1) + incr, neg_inf)

        # per object the highest bid wins, the lowest person on ties
        winner_bid = torch.full((B, O), NEG_INF, dtype=f32, device=dev).scatter_reduce(
            1, q1, bid, "amax")
        top = unassigned & (bid == winner_bid.gather(1, q1))
        winner_p = torch.full((B, O), P, dtype=torch.long, device=dev).scatter_reduce(
            1, q1, torch.where(top, iota_p, P), "amin")
        has_winner = winner_bid > half_neg_inf
        new_owner = torch.where(has_winner, winner_p, owner)
        new_prices = torch.where(has_winner, winner_bid, prices)

        # each person owns at most one object: rebuild the assignment
        slot = torch.where(new_owner >= 0, new_owner, P)
        new_assigned = torch.full((B, P + 1), -1, dtype=torch.long, device=dev).scatter_reduce(
            1, slot, iota_o.expand(B, O), "amax")[:, :P]
        new_assigned = torch.where(active, new_assigned, 0)

        # eps-scaling phase boundary: everyone assigned, eps above final
        shrink = ~open_persons(new_assigned) & (cur_eps > eps_stop)
        next_eps = torch.where(shrink, torch.maximum(cur_eps / SCALE_THETA, eps_fin), cur_eps)
        new_owner = torch.where(shrink[:, None], owner0, new_owner)
        new_assigned = torch.where(shrink[:, None], assigned0, new_assigned)

        r = running[:, None]
        owner = torch.where(r, new_owner, owner)
        assigned = torch.where(r, new_assigned, assigned)
        prices = torch.where(r, new_prices, prices)
        cur_eps = torch.where(running, next_eps, cur_eps)
        rounds = rounds + running.long()
        bids = bids + (unassigned & r).sum(1)
        running = still_running(assigned, cur_eps)
    return (assigned, rounds, bids) if with_stats else assigned


def smem_bytes(P, O, C, resident):
    """Shared memory of one block of a cluster of C (csrc/auction.cu's
    Layout): the block's rows when resident (ceil(P/C) of them, pitch O
    rounded up to 4), a replica of the O prices, its persons' best bid for
    each of the O objects (8 bytes), an inbox of the C blocks' best bids
    for each of its ceil(O/C) objects and their owners, its persons'
    assignment and active flag, and the cluster's flag rows."""
    O4 = (O + 3) // 4 * 4
    rp, op = -(-P // C), -(-O // C)
    prices = 4 * rp * O4 if resident else 0
    return (prices + 4 * O4 + 8 * O + 8 * op * C + 4 * op + 4 * rp + 4 * 2 * MAX_CLUSTER
            + rp)


def cluster_plan(B, P, O, cluster=None):
    """(C, resident, shared bytes a block) for a (B, P, O) auction: C =
    ``cluster`` (default CLUSTER) blocks an image, no more than P; without
    ``cluster`` the plan grows C up to MAX_CLUSTER where that makes the rows
    fit. Resident rows stay in the cluster's shared memory; otherwise they
    stream from L2 at C. The batch size does not change the plan."""
    C = max(1, min(cluster or CLUSTER, P))
    for c in [C] if cluster else range(C, max(C, min(MAX_CLUSTER, P)) + 1):
        if smem_bytes(P, O, c, True) <= MAX_SMEM:
            return c, True, smem_bytes(P, O, c, True)
    return C, False, smem_bytes(P, O, C, False)


def _lib() -> ctypes.CDLL:
    lib = _build.load("auction")
    if lib.auction_forward.argtypes is None:
        lib.auction_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.auction_forward.restype = ctypes.c_int
        lib.auction_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.auction_smem_bytes.restype = ctypes.c_longlong
        lib.auction_max_active_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.auction_max_active_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(P, O, C, resident):
    """Clusters of this plan the card holds at once (the CUDA occupancy
    query; 0 if none fits)."""
    n = ctypes.c_int(0)
    err = _lib().auction_max_active_clusters(P, O, C, int(resident), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"auction: cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return n.value


def _check(benefit, active, eps):
    for name, t in dict(benefit=benefit, active=active, eps=eps).items():
        if t.device != benefit.device:
            raise ValueError(f"auction: {name} is on {t.device}, benefit on {benefit.device}")
    if benefit.dtype != torch.float32 or benefit.dim() != 3:
        raise ValueError(f"auction: benefit must be (B, P, O) float32, got "
                         f"{benefit.dtype} {tuple(benefit.shape)}")
    B, P, O = benefit.shape
    if active.dtype != torch.bool or tuple(active.shape) != (B, P):
        raise ValueError(f"auction: active must be ({B}, {P}) bool, got "
                         f"{active.dtype} {tuple(active.shape)}")
    if eps.dtype != torch.float32 or tuple(eps.shape) != (B,):
        raise ValueError(f"auction: eps must be ({B},) float32, got {eps.dtype} {tuple(eps.shape)}")


def auction_assign(benefit, active, eps, max_iters, scaling=False, with_stats=False,
                   cluster=None):
    """The auction: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``auction_plain``;
    ``cluster`` overrides the plan's blocks per image (measurements)."""
    with trace.span("core.auction", lambda: "x".join(map(str, benefit.shape))):
        return _auction_forward(benefit, active, eps, max_iters, scaling, with_stats, cluster)


def _auction_forward(benefit, active, eps, max_iters, scaling, with_stats, cluster):
    if benefit.device.type == "cpu":
        return auction_plain(benefit, active, eps, max_iters, scaling, with_stats)
    if benefit.device.type != "cuda":
        raise ValueError(f"auction: no kernel for device {benefit.device}")
    _check(benefit, active, eps)
    B, P, O = benefit.shape
    assigned = torch.empty((B, P), dtype=torch.int32, device=benefit.device)
    rounds = torch.zeros((B,), dtype=torch.int32, device=benefit.device)
    bids = torch.zeros((B,), dtype=torch.int64, device=benefit.device)
    if B and P and O:
        lib = _lib()
        C, resident, smem = cluster_plan(B, P, O, cluster)
        if not 1 <= C <= MAX_CLUSTER or smem > MAX_SMEM:
            raise ValueError(f"auction: P={P}, O={O} on clusters of {C} need {smem} B of "
                             f"shared memory per block")
        if lib.auction_smem_bytes(P, O, C, int(resident)) != smem:
            raise RuntimeError("auction: smem_bytes disagrees with csrc/auction.cu's Layout")
        benefit = benefit.contiguous()
        active_u8 = active.to(torch.uint8).contiguous()
        eps = eps.contiguous()
        err = lib.auction_forward(
            benefit.data_ptr(), active_u8.data_ptr(), eps.data_ptr(),
            assigned.data_ptr(), rounds.data_ptr(), bids.data_ptr(),
            B, P, O, int(max_iters), int(bool(scaling)), C, int(resident),
            torch.cuda.current_stream(benefit.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"auction kernel launch failed: CUDA error {err}")
        trace.count("launch.auction")
    else:
        assigned.copy_(torch.where(active, -1, 0))
    assigned = assigned.long()
    return (assigned, rounds.long(), bids) if with_stats else assigned

"""The cluster auction's plan and round protocol against the JAX package, on
the CPU.

``csrc/auction.cu`` cannot run here, so ``cluster_auction`` below writes its
protocol in numpy: an image's persons and objects (interleaved) split over
C blocks, prices replicated in every block, each bidding row scanned the
way a half-warp scans it (each of 16 lanes in increasing column order,
float4 chunks from shared memory or scalar columns from L2, then a
butterfly that orders (value, lower index)), the (order_bits(bid),
~person) keys max-reduced in the bidder's own block, then over the C
blocks by the block owning the object, which awards it, and the done test
taken from the next round's bids (a phase boundary bids again at the same
round number; an image with no active person and the iteration cap are
settled as the kernel settles them). It must give assignments identical
to JAX ``matching._auction`` and to the Pallas ``auction_assign`` in
interpret mode, and rounds and bids identical to ``auction_plain``, for
C in {1, 2, 3, 8}: tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.ops import matching as jmatching
from countdetr_tpu.ops.pallas.auction_kernel import auction_assign as jax_auction_assign

from countdetr_tpu_torch.ops.kernels import auction_kernel
from countdetr_tpu_torch.ops.kernels.auction_kernel import (
    MAX_CLUSTER, MAX_SMEM, auction_plain, cluster_plan)

F32 = np.float32
HALF_NEG_INF = F32(-5e29)


# ------------------------------------------------------------------ plan ---

@pytest.mark.parametrize("cluster", [None, 4, 8, 16])
def test_plan_576x700(cluster):
    """The T=700 tier (queries bid over targets): resident wherever the rows
    fit; at 4 blocks they do not (403 KB a block) and stream."""
    C, resident, smem = cluster_plan(8, 576, 700, cluster)
    assert 1 < C <= MAX_CLUSTER and smem <= MAX_SMEM
    assert C == (cluster or auction_kernel.CLUSTER)
    assert resident == (C >= 8)
    if resident:  # the block's rows, pitch 700 floats, are most of it
        assert smem >= -(-576 // C) * 700 * 4


def test_plan_128x576_resident():
    """The T=128 tier (targets bid for queries) is resident."""
    C, resident, smem = cluster_plan(8, 128, 576)
    assert C > 1 and resident and smem <= MAX_SMEM


def test_plan_576x5600_streamed():
    """12.9 MB an image fits no cluster: the rows stream from L2."""
    C, resident, smem = cluster_plan(2, 576, 5600)
    assert C > 1 and not resident and smem <= MAX_SMEM
    assert smem >= 5600 * 4  # the price replica


@pytest.mark.parametrize("P,O", [(23, 43), (5, 5), (2, 30), (1, 9), (9, 1)])
def test_plan_odd_shapes(P, O):
    """Odd O: rows padded to a multiple of 4 in shared memory; never more
    blocks than persons."""
    C, resident, smem = cluster_plan(3, P, O)
    assert 1 <= C <= min(P, MAX_CLUSTER) and resident and smem <= MAX_SMEM
    assert smem == auction_kernel.smem_bytes(P, O, C, True)
    assert smem >= -(-P // C) * ((O + 3) // 4 * 4) * 4


# -------------------------------------------------------------- protocol ---

def order_bits(x):
    u = np.asarray(x, F32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000)).astype(np.uint64)


def from_order_bits(k):
    k = np.uint32(k)
    u = k & np.uint32(0x7FFFFFFF) if k & np.uint32(0x80000000) else ~k
    return np.asarray(u, np.uint32).view(F32)[()]


LANES = 16  # a bidding row's lanes: one half-warp


def row_scan(vals, vec):
    """(v1, v2, q1) of each row of ``vals`` (n, O) f32 as a half-warp finds
    them: lane l takes float4 chunks l, l + 16, ... (vec) or columns l,
    l + 16, ... in increasing order, a tie with its v1 going to v2; then the
    butterfly."""
    n, O = vals.shape
    o = np.arange(O)
    lane, step = (((o // 4) % LANES, (o // (4 * LANES)) * 4 + o % 4) if vec
                  else (o % LANES, o // LANES))
    S = int(step.max()) + 1
    grid = np.full((n, LANES, S), -np.inf, F32)
    idx = np.full((LANES, S), O)
    grid[:, lane, step] = vals
    idx[lane, step] = o
    v1 = np.full((n, LANES), -np.inf, F32)
    v2 = v1.copy()
    q1 = np.full((n, LANES), O)
    for s in range(S):
        val = grid[:, :, s]
        gt1 = val > v1
        gt2 = ~gt1 & (val > v2)
        v2 = np.where(gt1, v1, np.where(gt2, val, v2))
        q1 = np.where(gt1, idx[None, :, s], q1)
        v1 = np.where(gt1, val, v1)
    for off in (8, 4, 2, 1):
        perm = np.arange(LANES) ^ off
        ov1, ov2, oq1 = v1[:, perm], v2[:, perm], q1[:, perm]
        wins = (ov1 > v1) | ((ov1 == v1) & (oq1 < q1))
        v2 = np.where(wins, np.maximum(ov2, v1), np.maximum(v2, ov1))
        v1 = np.where(wins, ov1, v1)
        q1 = np.where(wins, oq1, q1)
    return v1[:, 0], v2[:, 0], q1[:, 0]


def cluster_image(benefit, active, eps_fin, max_iters, scaling, C, vec):
    """One image through csrc/auction.cu's protocol on C blocks."""
    P, O = benefit.shape
    rp, op = -(-P // C), -(-O // C)
    cta_p = [range(r * rp, min(P, (r + 1) * rp)) for r in range(C)]
    cta_o = [range(r, O, C) for r in range(C)]  # interleaved: object o in block o % C
    prices = [np.zeros(O, F32) for _ in range(C)]  # one replica a block
    best = [np.zeros(O, np.uint64) for _ in range(C)]  # a block's own persons' bids
    owner = [np.full(op, -1) for _ in range(C)]
    assigned = [np.where(active[list(ps)], -1, 0) for ps in cta_p]
    eps_stop = F32(eps_fin * F32(1.5))
    cur_eps = F32(eps_fin * F32(512.0)) if scaling else F32(eps_fin)
    bids = 0

    def shrink(e):
        return max(F32(e / F32(8.0)), F32(eps_fin))

    def bid_phase(probe):
        nonlocal bids
        any_bid = False
        for r in range(C):
            ps = np.asarray(cta_p[r], int)
            who = ps[active[ps] & (assigned[r] < 0)] if len(ps) else ps
            if not len(who):
                continue
            any_bid = True
            if probe:
                continue
            v1, v2, q1 = row_scan(benefit[who] - prices[r][None, :], vec)
            for p, a, b2, q in zip(who, v1, v2, q1):
                if not b2 > HALF_NEG_INF:
                    b2 = F32(a - F32(1.0))
                bid = F32(prices[r][q] + F32(F32(a - b2) + cur_eps))
                key = (order_bits(bid) << np.uint64(32)) | np.uint64(0xFFFFFFFF - p)
                best[r][q] = max(best[r][q], key)
                bids += 1
        return any_bid

    def reset():
        for r in range(C):
            owner[r][:] = -1
            assigned[r] = np.where(active[list(cta_p[r])], -1, 0)

    it, first = 0, True
    while True:
        if it >= max_iters:
            if it > 0 and cur_eps > eps_stop and not bid_phase(True):
                reset()
            break
        any_bid = bid_phase(False)
        none_active, first = first and not any_bid, False
        if not any_bid:
            if cur_eps <= eps_stop:
                break
            if none_active:
                while it < max_iters and cur_eps > eps_stop:
                    cur_eps, it = shrink(cur_eps), it + 1
                break
            cur_eps = shrink(cur_eps)
            reset()
            continue
        for r in range(C):  # award: each block settles its own objects
            for o in cta_o[r]:
                key = max(best[rr][o] for rr in range(C))
                for rr in range(C):
                    best[rr][o] = 0
                if key == 0:
                    continue
                bid = from_order_bits(int(key) >> 32)
                if not bid > HALF_NEG_INF:
                    continue
                p = 0xFFFFFFFF - (int(key) & 0xFFFFFFFF)
                old = owner[r][o // C]
                owner[r][o // C] = p
                for rr in range(C):
                    prices[rr][o] = bid
                assigned[p // rp][p % rp] = o
                if old >= 0:
                    assigned[old // rp][old % rp] = -1
        it += 1
    assert all(np.array_equal(prices[0], x) for x in prices)  # the replicas agree
    return np.concatenate(assigned), it, bids


def cluster_auction(benefit, active, eps, max_iters, scaling, C, vec=True):
    out = [cluster_image(benefit[b], active[b], eps[b], max_iters, scaling, C, vec)
           for b in range(benefit.shape[0])]
    return tuple(np.asarray(x) for x in zip(*out))


@functools.lru_cache(maxsize=None)
def _jax_bodies(key):
    benefit, active, eps, cap, scaling = _PROBLEMS[key]
    b, a, e = jnp.asarray(benefit), jnp.asarray(active), jnp.asarray(eps)
    xla = jax.vmap(lambda bb, aa, ee: jmatching._auction(bb, aa, ee, cap, scaling=scaling))(b, a, e)
    pallas = jax_auction_assign(b, a, e, cap, interpret=True, scaling=scaling)
    return np.asarray(xla), np.asarray(pallas)


_PROBLEMS = {}


def problem(name, seed, B, P, O, active_frac=0.8, cap=None, scaling=False):
    """An integer-cost problem (exact ties), as tests/test_torch_matching.py
    builds them, registered under ``name`` for the cached JAX answers."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(-4, 4, size=(B, P, O)).astype(F32)
    active = rng.random((B, P)) < active_frac
    if O == 1:
        active[:, 1:] = False
    benefit = np.where(active[:, :, None], -cost, 0.0).astype(F32)
    span = np.maximum(cost.max((1, 2)) - cost.min((1, 2)), 1e-3)
    eps = (span * 1e-3).astype(F32)
    _PROBLEMS[name] = (benefit, active, eps, 16 * O + 2048 if cap is None else cap, scaling)
    return name


def check_identical(name, C, vec=True):
    benefit, active, eps, cap, scaling = _PROBLEMS[name]
    got, rounds, bids = cluster_auction(benefit, active, eps, cap, scaling, C, vec)
    want, w_rounds, w_bids = (x.numpy() for x in auction_plain(
        torch.from_numpy(benefit), torch.from_numpy(active), torch.from_numpy(eps), cap,
        scaling=scaling, with_stats=True))
    xla, pallas = _jax_bodies(name)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rounds, w_rounds)
    np.testing.assert_array_equal(bids, w_bids)
    return got, rounds


TIES = {shape: problem(f"ties {shape}", i, *shape)
        for i, shape in enumerate([(3, 23, 43), (2, 5, 5), (2, 2, 30), (1, 1, 9), (2, 9, 1)])}


@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", list(TIES))
def test_cluster_protocol_identical_with_ties(shape, C):
    """Integer costs: exact ties between bids and within rows; resident
    rows (float4 chunks, padding past O)."""
    check_identical(TIES[shape], C)


CAP = {s: problem(f"cap {s}", 10 + s, 3, 40, 40, active_frac=2.0, cap=3, scaling=s)
       for s in (False, True)}


@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("scaling", [False, True])
def test_cluster_protocol_identical_at_an_iteration_cap(scaling, C):
    """A cap that leaves -1s; rows streamed as scalar columns."""
    got, rounds = check_identical(CAP[scaling], C, vec=False)
    assert (got == -1).any() and (rounds == 3).all()


SCALED = {n: problem(f"scaled {n}", 20 + n, 2, n, n, active_frac=2.0, scaling=True)
          for n in (17, 33)}


@pytest.mark.parametrize("n,C,vec", [(17, 1, True), (17, 2, True), (17, 3, False),
                                     (17, 8, True), (33, 8, False)])
def test_cluster_protocol_identical_with_eps_scaling(n, C, vec):
    """eps-scaling on square all-active problems: every phase boundary is
    found from the next round's bids and bid again at the same round."""
    check_identical(SCALED[n], C, vec)


NONE_ACTIVE = problem("none active", 30, 2, 6, 6, active_frac=-1.0, scaling=True)


@pytest.mark.parametrize("C", [2, 3])
def test_cluster_protocol_no_active_person(C):
    """Nobody bids: the rounds are the eps schedule's, as the plain version
    counts them."""
    _, rounds = check_identical(NONE_ACTIVE, C)
    assert (rounds > 0).all()


@pytest.mark.parametrize("C", [2, 3])
def test_cluster_protocol_every_cap_with_scaling(rng, C):
    """Every cap up to the finish on a scaled problem, so that some cap falls
    right after the award that ends a phase (the probe and its reset)."""
    cost = rng.integers(-4, 4, size=(2, 6, 6)).astype(F32)
    benefit = -cost
    active = np.ones((2, 6), bool)
    eps = (np.maximum(cost.max((1, 2)) - cost.min((1, 2)), 1e-3) * 1e-3).astype(F32)
    args = (torch.from_numpy(benefit), torch.from_numpy(active), torch.from_numpy(eps))
    _, full_rounds, _ = auction_plain(*args, 10_000, scaling=True, with_stats=True)
    for cap in range(1, int(full_rounds.max()) + 2):
        got, rounds, bids = cluster_auction(benefit, active, eps, cap, True, C)
        want, w_rounds, w_bids = auction_plain(*args, cap, scaling=True, with_stats=True)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(rounds, w_rounds.numpy(), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(bids, w_bids.numpy(), err_msg=f"cap {cap}")

"""The port's matcher against the JAX package, on the CPU.

``auction_plain`` (the CUDA auction kernel's oracle) must give assignments
bit-identical to both JAX auction bodies: the vmapped XLA ``_auction`` and
the Pallas ``auction_assign`` in interpret mode. Integer costs force exact
ties, so the first-index tie-breaks are exercised; tolerance 0 on the
assignments. ``batched_match`` must equal the JAX
``batched_match`` in both orientations, and stay near the scipy optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from countdetr_tpu.ops import matching as jmatching
from countdetr_tpu.ops.pallas.auction_kernel import auction_assign as jax_auction_assign

from countdetr_tpu_torch.ops import matching as tmatching
from countdetr_tpu_torch.ops.kernels.auction_kernel import auction_assign, auction_plain


def integer_problem(rng, B, P, O, active_frac=0.8):
    cost = rng.integers(-4, 4, size=(B, P, O)).astype(np.float32)
    active = rng.random((B, P)) < active_frac
    benefit = np.where(active[:, :, None], -cost, 0.0).astype(np.float32)
    span = np.maximum(cost.max((1, 2)) - cost.min((1, 2)), 1e-3)
    eps = (span * 1e-3).astype(np.float32)
    return benefit, active, eps


def jax_bodies(benefit, active, eps, cap, scaling):
    b, a, e = jnp.asarray(benefit), jnp.asarray(active), jnp.asarray(eps)
    xla = jax.vmap(lambda bb, aa, ee: jmatching._auction(bb, aa, ee, cap, scaling=scaling))(b, a, e)
    pallas = jax_auction_assign(b, a, e, cap, interpret=True, scaling=scaling)
    return np.asarray(xla), np.asarray(pallas)


def port(benefit, active, eps, cap, scaling):
    return auction_plain(torch.from_numpy(benefit), torch.from_numpy(active),
                         torch.from_numpy(eps), cap, scaling=scaling, with_stats=True)[:2]


@pytest.mark.parametrize("B,P,O", [(3, 23, 43), (2, 5, 5), (2, 2, 30), (1, 1, 9), (2, 9, 1)])
def test_auction_plain_identical_to_jax_bodies_with_ties(rng, B, P, O):
    benefit, active, eps = integer_problem(rng, B, P, O)
    if O == 1:
        active[:, 1:] = False  # one object: at most one person can hold it
    cap = 16 * O + 2048
    got, rounds = port(benefit, active, eps, cap, scaling=False)
    xla, pallas = jax_bodies(benefit, active, eps, cap, scaling=False)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(rounds.numpy() > 0, active.any(1))
    # the wrapper takes the plain path on CPU tensors
    again = auction_assign(torch.from_numpy(benefit), torch.from_numpy(active),
                           torch.from_numpy(eps), cap)
    np.testing.assert_array_equal(again.numpy(), xla)


@pytest.mark.parametrize("B,N", [(2, 17), (1, 33)])
def test_auction_plain_identical_to_jax_bodies_scaled_square(rng, B, N):
    """scaling=True on square all-active problems: same phase boundaries,
    same carried prices, same tie-breaks; and the scipy optimum's cost."""
    benefit, active, eps = integer_problem(rng, B, N, N, active_frac=2.0)
    cap = 16 * N + 2048
    got, _ = port(benefit, active, eps, cap, scaling=True)
    xla, pallas = jax_bodies(benefit, active, eps, cap, scaling=True)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    for b in range(B):
        rows, cols = linear_sum_assignment(-benefit[b])
        opt = -benefit[b][rows, cols].sum()
        ours = -benefit[b][np.arange(N), got[b].numpy()].sum()
        assert ours <= opt + 0.05 * max(1.0, abs(opt)), (b, ours, opt)


@pytest.mark.parametrize("scaling", [False, True])
def test_auction_plain_identical_at_an_iteration_cap(rng, scaling):
    """A cap too small to finish leaves -1s, at the same persons, and every
    image runs exactly the cap."""
    benefit, active, eps = integer_problem(rng, 3, 40, 40, active_frac=2.0)
    cap = 3
    got, rounds = port(benefit, active, eps, cap, scaling)
    xla, pallas = jax_bodies(benefit, active, eps, cap, scaling)
    assert (got.numpy() == -1).any()
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(rounds.numpy(), [cap] * 3)


@pytest.mark.parametrize("B,Q,T", [(3, 40, 25), (3, 12, 40), (2, 20, 20)])
def test_batched_match_equals_jax(rng, B, Q, T):
    """Both orientations (targets bid when T <= Q, queries bid over targets
    with dummy objects when T > Q), partly invalid targets."""
    cost = rng.normal(size=(B, Q, T)).astype(np.float32) * 5
    valid = np.ones((B, T), dtype=bool)
    valid[0, T // 2:] = False
    valid[-1, :3] = False
    want_tq, want_m = (np.asarray(x) for x in jmatching.batched_match(
        jnp.asarray(cost), jnp.asarray(valid)))
    got_tq, got_m = tmatching.batched_match(torch.from_numpy(cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_tq.numpy(), want_tq)


def test_batched_match_scaled_equals_jax(rng, monkeypatch):
    """The square eps-scaled reduction (off by default in both packages):
    the port's keyword against the JAX package's switch."""
    monkeypatch.setattr(jmatching, "AUCTION_SCALING", True)
    jmatching.batched_match.clear_cache()
    try:
        cost = rng.normal(size=(2, 10, 24)).astype(np.float32) * 5
        valid = np.ones((2, 24), dtype=bool)
        valid[1, 16:] = False
        want_tq, want_m = (np.asarray(x) for x in jmatching.batched_match(
            jnp.asarray(cost), jnp.asarray(valid)))
    finally:
        jmatching.batched_match.clear_cache()
    got_tq, got_m = tmatching.batched_match(torch.from_numpy(cost), torch.from_numpy(valid),
                                            scaling=True)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_tq.numpy(), want_tq)


def test_dummy_rows_unit_equals_jax():
    np.testing.assert_array_equal(tmatching.dummy_rows_unit(37, 300).numpy(),
                                  np.asarray(jmatching._dummy_rows_unit(37, 300)))


@pytest.mark.parametrize("B,Q,T", [(2, 30, 18), (2, 12, 30)])
def test_batched_match_near_scipy_optimum(rng, B, Q, T):
    """Within the auction's eps bound of the exact LAP, and the exact route
    is scipy's own answer."""
    cost = rng.normal(size=(B, Q, T)).astype(np.float32) * 5
    valid = np.ones((B, T), dtype=bool)
    got, matched = (x.numpy() for x in tmatching.batched_match(
        torch.from_numpy(cost), torch.from_numpy(valid)))
    assert (matched.sum(1) == min(Q, T)).all()
    ex_tq, ex_m = tmatching.exact_batched_match(torch.from_numpy(cost), torch.from_numpy(valid))
    want_tq, want_m = jmatching.scipy_match(cost, valid)
    np.testing.assert_array_equal(ex_tq.numpy(), want_tq)
    np.testing.assert_array_equal(ex_m.numpy(), want_m)
    for b in range(B):
        rows, cols = linear_sum_assignment(cost[b])
        opt = cost[b][rows, cols].sum()
        ours = cost[b][got[b][matched[b]], np.nonzero(matched[b])[0]].sum()
        assert ours <= opt + 1e-2 * max(1.0, abs(opt)), (b, ours, opt)

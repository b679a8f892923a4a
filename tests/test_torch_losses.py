"""The port's box ops, focal loss, matching cost and stage-2 criterion
against the JAX package, on the CPU, float32, rtol 1e-5 (atol 1e-6 for
values near 0). The criterion gets identical MatchedTargets on both sides,
so the matcher cannot decide the comparison; its gradients are held
against jax.grad as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.ops import boxes as jboxes
from countdetr_tpu.ops import losses as jlosses

from countdetr_tpu_torch.ops import boxes as tboxes
from countdetr_tpu_torch.ops import losses as tlosses

RTOL, ATOL = 1e-5, 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def cxcywh(rng, *lead):
    c = rng.uniform(0.2, 0.8, (*lead, 2))
    wh = rng.uniform(0.02, 0.4, (*lead, 2))
    return np.concatenate([c, wh], -1).astype(np.float32)


def test_box_ops_match_jax(rng):
    a, b = cxcywh(rng, 2, 7), cxcywh(rng, 2, 5)
    a[0, 0] = (0.5, 0.5, 0.0, 0.0)  # degenerate box: 0, not NaN
    xa, xb = jboxes.box_cxcywh_to_xyxy(a), jboxes.box_cxcywh_to_xyxy(b)
    ta, tb = tboxes.box_cxcywh_to_xyxy(t(a)), tboxes.box_cxcywh_to_xyxy(t(b))
    close(ta, xa)
    close(tboxes.box_xyxy_to_cxcywh(ta), jboxes.box_xyxy_to_cxcywh(xa))
    close(tboxes.box_area(ta), jboxes.box_area(xa))
    for g, w in zip(tboxes.box_iou_pairwise(ta, tb), jboxes.box_iou_pairwise(xa, xb)):
        close(g, w)
    for g, w in zip(tboxes.box_iou_aligned(ta, ta.flip(1)), jboxes.box_iou_aligned(xa, xa[:, ::-1])):
        close(g, w)
    close(tboxes.generalized_box_iou_pairwise(ta, tb), jboxes.generalized_box_iou_pairwise(xa, xb))
    close(tboxes.generalized_box_iou_aligned(ta, ta.flip(1)),
          jboxes.generalized_box_iou_aligned(xa, xa[:, ::-1]))
    assert torch.isfinite(tboxes.generalized_box_iou_pairwise(ta, tb)).all()


@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_sigmoid_focal_loss_matches_jax(rng, alpha):
    logits = (rng.normal(size=(2, 9, 2)) * 4).astype(np.float32)
    targets = (rng.random((2, 9, 2)) < 0.3).astype(np.float32)
    close(tlosses.sigmoid_focal_loss(t(logits), t(targets), alpha=alpha),
          jlosses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), alpha=alpha))


def test_stage2_cost_matrix_matches_jax(rng):
    B, Q, T = 2, 11, 7
    logits = rng.normal(size=(B, Q, 2)).astype(np.float32)
    pred, tgt = cxcywh(rng, B, Q), cxcywh(rng, B, T)
    labels = rng.integers(0, 2, (B, T)).astype(np.int32)
    want = jlosses.stage2_cost_matrix(jnp.asarray(logits), jnp.asarray(pred),
                                      jnp.asarray(tgt), jnp.asarray(labels))
    got = tlosses.stage2_cost_matrix(t(logits), t(pred), t(tgt), t(labels))
    assert got.shape == (B, Q, T)
    close(got, want)


def criterion_case(rng, B, Q, T, matched_subset, batch_valid):
    logits = rng.normal(size=(B, Q, 2)).astype(np.float32)
    pred, tgt = cxcywh(rng, B, Q), cxcywh(rng, B, T)
    pvars = rng.uniform(-1.5, 1.5, (B, Q, 2)).astype(np.float32)
    labels = np.zeros((B, T), np.int32)
    valid = np.ones((B, T), bool)
    valid[-1, T - 3:] = False
    tq = np.stack([rng.permutation(max(Q, T))[:T] % Q for _ in range(B)]).astype(np.int32)
    matched = None
    if matched_subset:  # T > Q: a distinct query for min(Q, #valid) targets
        matched = np.zeros((B, T), bool)
        for b in range(B):
            winners = rng.permutation(np.nonzero(valid[b])[0])[:Q]
            matched[b, winners] = True
            tq[b, winners] = rng.permutation(Q)[:len(winners)]
    bv = np.array([True] + [False] * (B - 1)) if batch_valid else None
    return logits, pred, pvars, tgt, labels, tq, valid, matched, bv


@pytest.mark.parametrize("B,Q,T,matched_subset,batch_valid", [
    (2, 12, 7, False, False),  # T <= Q: every valid target matched
    (2, 6, 15, True, False),  # T > Q: a matched subset
    (3, 12, 7, False, True),  # padded batch rows
])
def test_stage2_criterion_matches_jax(rng, B, Q, T, matched_subset, batch_valid):
    logits, pred, pvars, tgt, labels, tq, valid, matched, bv = criterion_case(
        rng, B, Q, T, matched_subset, batch_valid)
    jm = jlosses.MatchedTargets(jnp.asarray(tq), jnp.asarray(valid),
                                None if matched is None else jnp.asarray(matched))
    tm = tlosses.MatchedTargets(t(tq), t(valid), None if matched is None else t(matched))

    def jax_total(lg, pb, pv):
        parts = jlosses.stage2_criterion(
            lg, pb, pv, jnp.asarray(tgt), jnp.asarray(labels), jm,
            batch_valid=None if bv is None else jnp.asarray(bv))
        total = (2 * parts["loss_ce"] + 5 * parts["loss_bbox"] + 2 * parts["loss_giou"]
                 + 2 * parts["loss_variance"])
        return total, parts

    (want_total, want), want_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(pred), jnp.asarray(pvars))
    inputs = [t(x).requires_grad_() for x in (logits, pred, pvars)]
    got = tlosses.stage2_criterion(*inputs, t(tgt), t(labels), tm,
                                   batch_valid=None if bv is None else t(bv))
    total = (2 * got["loss_ce"] + 5 * got["loss_bbox"] + 2 * got["loss_giou"]
             + 2 * got["loss_variance"])
    total.backward()
    assert set(got) == set(want)
    for key in want:
        close(got[key].detach(), want[key])
    close(total.detach(), want_total)
    for x, g in zip(inputs, want_grads):
        close(x.grad, g)
    assert not got["cardinality_error"].requires_grad and not got["class_error"].requires_grad

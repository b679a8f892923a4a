"""``ModelConfig.remat`` (models/transformer.py: each encoder and decoder
layer under a non-reentrant ``torch.utils.checkpoint``) on the CPU.

- Remat on against off, the same weights and batch: the stage-2 loss and
  every gradient equal bit for bit (the recompute runs the same ops on the
  same inputs), in stage 2 under both attention types and in stage 1.
- With dropout 0.1, the same: the recompute restores the step's
  ``torch.Generator`` to its state at the layer, so it draws the forward's
  masks. A copy of ``remat`` without that restore gives other gradients,
  so the check sees it.
- The port with remat against the JAX package with ``remat=True``
  (nn.remat of its layers), both in float64 (JAX under ``enable_x64``, as
  tests/test_torch_longtail_grad.py: in float32 a ReLU input within
  rounding of zero takes the other side in one framework, and moved the
  backbone's ``layer2_0/conv1`` gradient here by 1.3e-3) and matching by
  the exact LAP: the loss parts within 1e-6 relative and each trained
  leaf's gradient within 1e-4 of its norm (a norm counted as at least
  1e-4 of the largest leaf's), as in that test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train.optimizer import _label as jax_label
from countdetr_tpu.train.train_step import stage2_loss as jax_stage2_loss

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.models import transformer
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train.train_step import (
    dropout_generator, prepare_stage1_batch, prepare_stage2_batch, stage1_loss, stage2_loss,
)
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_ddp import jax_model_params, stage1_global_batch, stage2_global_batch
from test_torch_train import leaves_by_name, port_as_jax
from torch_ddp_worker import model_config

EXACT = TrainConfig(exact_match=True)
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models, dispatch more than arithmetic: one intra-op thread
    spares the port's side the thread pool's cost while the suite's other
    workers hold every core (as in tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_and_grads(stage, remat, dropout=0.0, **kw):
    """The loss parts and the named gradients of a seeded model, remat on or
    off, with a dropout generator when ``dropout`` > 0."""
    if stage == 2:
        kw.setdefault("num_query_position", 25)
    model = build_model(model_config((stage, dict(kw, remat=remat, dropout=dropout))),
                        device="cpu", seed=1).train()
    g = dropout_generator(0, 3, "cpu") if dropout else None
    if stage == 2:
        total, parts, _ = stage2_loss(model, prepare_stage2_batch(stage2_global_batch(0), "cpu"),
                                      EXACT, generator=g)
    else:
        total, parts = stage1_loss(model, prepare_stage1_batch(stage1_global_batch(0), "cpu"),
                                   EXACT, generator=g)
    total.backward()
    return ({k: v.detach() for k, v in parts.items()},
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None})


def assert_equal(a, b):
    (pa, ga), (pb, gb) = a, b
    assert set(pa) == set(pb) and set(ga) == set(gb) and ga
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("stage, kw", [(2, {}), (2, {"attention_type": "MHA"}), (1, {})],
                         ids=["stage2", "stage2-mha", "stage1"])
def test_remat_gives_the_same_loss_and_gradients(stage, kw):
    assert_equal(loss_and_grads(stage, True, **kw), loss_and_grads(stage, False, **kw))


def test_remat_recompute_draws_the_forward_dropout_masks(monkeypatch):
    off = loss_and_grads(2, False, dropout=0.1)
    assert_equal(loss_and_grads(2, True, dropout=0.1), off)
    # the masks matter: another generator gives another loss
    other = build_model(model_config((2, dict(num_query_position=25, dropout=0.1))),
                        device="cpu", seed=1).train()
    loss = stage2_loss(other, prepare_stage2_batch(stage2_global_batch(0), "cpu"), EXACT,
                       generator=dropout_generator(0, 4, "cpu"))[1]["loss"]
    assert not torch.equal(loss.detach(), off[0]["loss"])

    def remat_without_restore(layer, *args, generator=None):
        return checkpoint(lambda *a: layer(*a, generator=generator), *args,
                          use_reentrant=False)

    monkeypatch.setattr(transformer, "remat", remat_without_restore)
    parts, grads = loss_and_grads(2, True, dropout=0.1)
    assert torch.equal(parts["loss"], off[0]["loss"])  # the forward is the same
    assert any(not torch.equal(grads[k], off[1][k]) for k in grads)


def test_remat_matches_jax_remat():
    batch = stage2_global_batch(2)
    _, cfg, params = jax_model_params(2, batch, 1e-4)
    with jax.enable_x64():
        jc = cfg.model.replace(remat=True, compute_dtype="float64")
        cfg, jmodel = cfg.replace(model=jc), JaxCountingDetr(jc)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["labels"] = jnp.zeros(batch["boxes"].shape[:2], jnp.int32)
        (_, want_parts), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_stage2_loss(jmodel, p, jb, cfg), has_aux=True))(params)
        want_parts = {k: float(v) for k, v in want_parts.items()}
        grads = jax.tree_util.tree_map(np.asarray, grads)
    trained = {k for k, v in leaves_by_name(jax.tree_util.tree_map_with_path(
        lambda p, _: jax_label(p) != "frozen", params)).items() if v}

    pc = model_config((2, dict(num_query_position=25, remat=True, compute_dtype="float64")))
    model = build_model(pc, device="cpu", state_dict=params_from_jax(params)).train()
    total, parts, _ = stage2_loss(model, prepare_stage2_batch(batch, "cpu"), EXACT)
    total.backward()
    for k, w in want_parts.items():
        np.testing.assert_allclose(parts[k].item(), w, rtol=1e-6, err_msg=k)
    with torch.no_grad():
        for p in model.parameters():  # the gradients in the weights' places
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    got, want = port_as_jax(model, params), leaves_by_name(grads)
    assert len(trained) == sum(p.requires_grad for p in model.parameters())
    floor = REL * max(float(np.linalg.norm(want[k])) for k in trained)
    for key in sorted(trained):
        norm = float(np.linalg.norm(want[key]))
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= REL * max(norm, floor), (key, err, norm)

"""The port's dropout, on the CPU.

Its masks come from a ``torch.Generator`` and the JAX package's from a JAX
rng, so the two cannot draw the same masks; the tests hold the properties
instead:

- the layer's arithmetic is flax's ``nn.Dropout``: at rate 0.1 the dropped
  share of 4M elements is within 1% of 0.1 (relative; its standard error is
  0.15%), kept values are x / 0.9, in float32 and bfloat16;
- rate 0 in training mode equals eval mode bit for bit;
- eval mode ignores the rate: the port's eval forward at rate 0.1 equals
  its rate-0 forward bit for bit and the JAX package's deterministic
  forward within 1e-4 (the tolerance of tests/test_torch_model.py);
- the same seed and step draw the same masks, another step or seed others;
  a Trainer's steps are reproducible, and a run resumed from a state dict
  draws the step's masks again (the generator is seeded from the seed and
  the step, as the JAX package folds the step into its key).
"""

import copy

import numpy as np
import pytest
import torch

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.models.transformer import dropout
from countdetr_tpu_torch.train.train_step import Trainer, dropout_generator
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_priors import configs, jax_reference, make_inputs, port_args
from test_torch_train import make_train_batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_share_and_scale(dtype):
    x = torch.ones(2000, 2000, dtype=dtype)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert y.dtype == dtype
    share = (y == 0).float().mean().item()
    assert abs(share - 0.1) < 0.01 * 0.1, share
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0) / 0.9)
    # no generator, or rate 0: the identity
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, torch.Generator()) is x


def stage2_model(rate, seed=0, **kw):
    cfg = configs(2, "learned")[1].replace(dropout=rate, **kw)
    return build_model(cfg, device="cpu", seed=seed)


def forward(model, x, generator=None):
    with torch.no_grad():
        return model(*port_args(2, x), generator=generator)


def assert_outputs_equal(a, b):
    for k in ("pred_logits", "pred_boxes", "pred_vars"):
        assert torch.equal(a[k], b[k]), k
    for ga, gb in zip(a["aux_outputs"], b["aux_outputs"]):
        assert all(torch.equal(ga[k], gb[k]) for k in ga)


def test_rate_zero_in_training_mode_equals_eval_mode():
    model, x = stage2_model(0.0), make_inputs(3)
    evald = forward(model.eval(), x)
    trained = forward(model.train(), x, dropout_generator(42, 0, "cpu"))
    assert_outputs_equal(trained, evald)


def test_eval_mode_ignores_the_rate_as_jax():
    _, params, want = jax_reference(2, "learned")  # dropout 0.0; JAX eval ignores the rate
    sd = params_from_jax(params)
    at_rate = build_model(configs(2, "learned")[1].replace(dropout=0.1), device="cpu",
                          state_dict=sd)
    plain = build_model(configs(2, "learned")[1], device="cpu", state_dict=sd)
    x = make_inputs(1)
    got = forward(at_rate, x, dropout_generator(42, 0, "cpu"))  # eval mode: ignored
    assert_outputs_equal(got, forward(plain, x))
    for k in ("pred_logits", "pred_boxes", "pred_vars"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)


def test_same_seed_and_step_draw_the_same_masks():
    model, x = stage2_model(0.1).train(), make_inputs(3)
    a = forward(model, x, dropout_generator(42, 5, "cpu"))
    assert_outputs_equal(a, forward(model, x, dropout_generator(42, 5, "cpu")))
    for other in (dropout_generator(42, 6, "cpu"), dropout_generator(43, 5, "cpu")):
        b = forward(model, x, other)
        assert not torch.equal(a["pred_logits"], b["pred_logits"])
    evald = forward(model.eval(), x)
    assert not torch.equal(a["pred_logits"], evald["pred_logits"])
    # without a generator the training-mode forward is deterministic
    assert_outputs_equal(forward(model.train(), x), evald)


def test_trainer_steps_are_reproducible_and_resume_draws_the_same_masks():
    cfg = configs(2, "learned")[1].replace(dropout=0.1, enc_layers=1, dec_layers=2)
    batches = [make_train_batch(s) for s in range(2)]

    def trainer(seed=42):
        return Trainer(cfg, TrainConfig(seed=seed), device="cpu", seed=0)

    whole = trainer()
    losses = [float(whole.step(b)["loss"]) for b in batches]
    again = trainer()
    assert [float(again.step(b)["loss"]) for b in batches] == losses
    half = trainer()
    half.step(batches[0])
    resumed = trainer()
    resumed.load_state_dict(copy.deepcopy(half.state_dict()))
    assert float(resumed.step(batches[1])["loss"]) == losses[1]
    other = trainer(seed=7)
    assert float(other.step(batches[0])["loss"]) != losses[0]
    # eval_step has no dropout: the rate-0 model on the same weights agrees
    plain = Trainer(cfg.replace(dropout=0.0), TrainConfig(), device="cpu",
                    state_dict=whole.model.state_dict())
    got, want = whole.eval_step(batches[0]), plain.eval_step(batches[0])
    assert all(torch.equal(got[k], want[k]) for k in want)

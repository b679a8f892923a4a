"""The port's checkpoints on the CPU, against the JAX package where it has
a counterpart: the full Trainer state round-trips bit-exactly through
``save_checkpoint``/``restore_checkpoint`` and ``AsyncSaver`` (which
copies at ``save`` and commits in order); ``gc_checkpoints`` keeps JAX's
set; an interrupted run resumes to the uninterrupted run's losses
exactly (the CPU is deterministic); a restored checkpoint's forward equals
the JAX forward of the params it came from (atol 1e-4, the model parity
tolerance of tests/test_torch_model.py); ``load_torch_checkpoint`` reads a
reference-layout .pth to the JAX importer's weights exactly, and to the
weights it was written from exactly but for the bbox head's last bias,
which the wh bias entered and left again (atol 1e-6).
"""

import argparse
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.train import checkpoints as jckpt

from countdetr_tpu_torch.config import TrainConfig, stage1_config
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import BBOX_LAST_BIAS, jax_model_and_params, make_batch, tiny_configs
from test_torch_stage1 import TINY1
from test_torch_train import make_train_batch


def tiny_trainer(seed, steps_per_epoch=2, **train_kw):
    return Trainer(tiny_configs()[1], TrainConfig(lr_drop=1, **train_kw), device="cpu",
                   seed=seed, steps_per_epoch=steps_per_epoch)


def flat(obj, prefix=""):
    """(key path, leaf) pairs of nested dicts and lists."""
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in flat(v, f"{prefix}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [x for i, v in enumerate(obj) for x in flat(v, f"{prefix}/{i}")]
    return [(prefix, obj)]


def assert_states_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def stepped():
    """A Trainer after 3 steps (an LR drop inside, a non-zero bad_steps)."""
    trainer = tiny_trainer(0)
    for s in range(3):
        trainer.step(make_train_batch(s))
    trainer.bad_steps += 2
    return trainer


def test_save_restore_round_trips_the_full_state(stepped, tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 4, stepped, {"epoch": 4})
    assert ckpt.latest_step(str(tmp_path)) == 4
    fresh = tiny_trainer(1)
    meta = ckpt.restore_checkpoint(str(tmp_path), 4, fresh)
    assert meta["epoch"] == 4 and meta["step"] == 4 and meta["opt_step"] == 3
    assert meta["config"]["model"]["hidden_dim"] == 32 and meta["config"]["train"]["lr_drop"] == 1
    assert_states_equal(fresh.state_dict(), stepped.state_dict())
    assert int(fresh.bad_steps) == 2 and fresh.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)
    # the payload loads under torch.load's default weights_only=True
    payload = torch.load(tmp_path / "checkpoint_4" / ckpt.PAYLOAD, weights_only=True)
    assert set(payload) == {"model", "optimizer", "scheduler", "bad_steps", "step"}


def test_async_saver_copies_at_save_and_commits_in_order(stepped, tmp_path):
    d = str(tmp_path)
    saver = ckpt.AsyncSaver()
    trainer = tiny_trainer(2)
    trainer.load_state_dict(stepped.state_dict())
    want = ckpt._host_copy(trainer.state_dict())
    saver.save(d, 0, trainer, {"epoch": 0})
    trainer.step(make_train_batch(5))  # training goes on while the write runs
    assert ckpt.latest_step(d) is None  # nothing published before the commit
    assert not os.path.exists(os.path.join(d, "checkpoint_0.meta.json"))
    saver.save(d, 1, trainer, {"epoch": 1})  # commits 0 first
    assert ckpt.latest_step(d) == 0
    saver.finalize()
    saver.finalize()  # idempotent
    assert ckpt.latest_step(d) == 1
    fresh = tiny_trainer(3)
    ckpt.restore_checkpoint(d, 0, fresh)
    assert_states_equal(fresh.state_dict(), want)
    assert not torch.equal(fresh.model.state_dict()[BBOX_LAST_BIAS],
                           trainer.model.state_dict()[BBOX_LAST_BIAS])
    assert sorted(os.listdir(d)) == ["checkpoint_0", "checkpoint_0.meta.json", "checkpoint_1",
                                     "checkpoint_1.meta.json", "latest.json"]


def make_ckpt_dir(root, steps, committed, latest):
    os.makedirs(root)
    for s in steps:
        os.makedirs(os.path.join(root, f"checkpoint_{s}"))
        if s in committed:
            with open(os.path.join(root, f"checkpoint_{s}.meta.json"), "w") as f:
                json.dump({"step": s}, f)
    with open(os.path.join(root, "latest.json"), "w") as f:
        json.dump({"step": latest}, f)


@pytest.mark.parametrize("keep_last,keep_every,lr_drop,drop_epochs,latest", [
    (1, 10, None, None, 23), (3, 5, 7, None, 17), (2, 0, None, (4, 12), 24), (1, 10, 200, None, 2),
])
def test_gc_checkpoints_keeps_the_jax_set(tmp_path, keep_last, keep_every, lr_drop,
                                         drop_epochs, latest):
    steps = list(range(25))
    committed = [s for s in steps if s not in (6, 24)]  # two writes still in flight
    kw = dict(keep_last=keep_last, keep_every=keep_every, lr_drop=lr_drop,
              drop_epochs=drop_epochs)
    for side, gc in (("port", ckpt.gc_checkpoints), ("jax", jckpt.gc_checkpoints)):
        make_ckpt_dir(str(tmp_path / side), steps, committed, latest)
        gc(str(tmp_path / side), **kw)
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == sorted(os.listdir(tmp_path / "jax"))
    assert "checkpoint_6" in kept and "checkpoint_24" in kept and f"checkpoint_{latest}" in kept
    assert len(kept) < 2 * len(committed)


def test_interrupted_run_resumes_to_the_same_losses(tmp_path):
    batches = [make_train_batch(s) for s in range(3)]
    whole = tiny_trainer(4)
    losses = [float(whole.step(b)["loss"]) for b in batches]
    first = tiny_trainer(4)
    part = [float(first.step(b)["loss"]) for b in batches[:1]]
    saver = ckpt.AsyncSaver(keep_last=1)
    saver.save(str(tmp_path), 1, first, {"epoch": 1})  # an LR drop lies ahead
    saver.finalize()
    del first
    resumed = tiny_trainer(5)
    meta = ckpt.restore_checkpoint(str(tmp_path), ckpt.latest_step(str(tmp_path)), resumed)
    assert meta["epoch"] == 1
    part += [float(resumed.step(b)["loss"]) for b in batches[1:]]
    assert part == losses
    assert_states_equal(resumed.state_dict(), whole.state_dict())


def test_restored_checkpoint_forward_matches_jax(tmp_path):
    jmodel, params = jax_model_and_params(seed=6, cfg=tiny_configs()[0])
    src = Trainer(tiny_configs()[1], TrainConfig(), device="cpu",
                  state_dict=params_from_jax(params))
    ckpt.save_checkpoint(str(tmp_path), 0, src)
    dst = tiny_trainer(7)
    ckpt.restore_checkpoint(str(tmp_path), 0, dst)
    packed, mask, rects = make_batch(8)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(packed), jnp.asarray(mask),
                                 exemplar_boxes=jnp.asarray(rects))
    with torch.inference_mode():
        got = dst.model.eval()(torch.from_numpy(packed), torch.from_numpy(mask),
                               torch.from_numpy(rects))
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def reference_pth(model, path, stage):
    """The model's weights as the reference saves them: the Joiner prefix,
    the wh bias folded in, the shared heads stored once per decoder layer,
    stage 2's unused plain input_proj, stage 1's (1,) cls bias, the
    adapt_pos1d the reference keeps under standard attention too, with a
    mask head DETRsegm's ``detr.`` prefix on all but bbox_attention and
    mask_head, thop counters and a pickled argparse Namespace."""
    sd = {}
    for k, v in model.state_dict().items():
        sd[k.replace("backbone.body.", "backbone.0.body.")] = v.clone()
    sd[BBOX_LAST_BIAS] += torch.tensor([0.0, 0.0, -2.0, -2.0])
    for k in [k for k in sd if k.startswith(("transformer.cls_embed.0.",
                                             "transformer.bbox_embed.0.",
                                             "transformer.bbox_variance.0."))]:
        for j in range(1, 6):
            sd[k.replace(".0.", f".{j}.", 1)] = sd[k].clone()
    C = model.cfg.hidden_dim
    if stage == 2:
        sd["input_proj.0.0.weight"] = torch.zeros(C, 2048, 1, 1)
        sd["input_proj.0.0.bias"] = torch.zeros(C)
        sd["input_proj.0.1.weight"] = torch.ones(C)  # its GroupNorm
        sd["input_proj.0.1.bias"] = torch.zeros(C)
    else:
        sd["transformer.cls_embed.0.bias"] = sd["transformer.cls_embed.0.bias"][:1].clone()
    if "transformer.adapt_pos1d.0.weight" not in sd:
        for j in (0, 2):
            sd[f"transformer.adapt_pos1d.{j}.weight"] = torch.zeros(C, C)
            sd[f"transformer.adapt_pos1d.{j}.bias"] = torch.zeros(C)
    if model.cfg.masks:
        sd = {k if k.startswith(("bbox_attention.", "mask_head.")) else "detr." + k: v
              for k, v in sd.items()}
    sd["total_ops"] = torch.zeros(1)
    torch.save({"model": sd, "args": argparse.Namespace(lr=1e-4), "epoch": 3}, path)
    return sd


@pytest.mark.parametrize("stage", [1, 2])
def test_load_torch_checkpoint_matches_the_jax_importer(tmp_path, stage):
    if stage == 2:
        _, params = jax_model_and_params(seed=9, cfg=tiny_configs()[0])
        src = build_model(tiny_configs()[1], device="cpu", state_dict=params_from_jax(params))
    else:
        src = build_model(stage1_config(**TINY1), device="cpu", seed=9)
        with torch.no_grad():  # the (1,)-bias quirk: equal class biases
            src.transformer.cls_embed[0].bias.fill_(-4.5)
    path = str(tmp_path / "ref.pth")
    sd = reference_pth(src, path, stage)
    dst = build_model(src.cfg, device="cpu", seed=1)
    got = ckpt.load_torch_checkpoint(path, dst)
    dst.load_state_dict(got)
    want = src.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=1e-6 if k == BBOX_LAST_BIAS else 0,
                                   rtol=0, msg=k)
    if stage == 2:  # the JAX importer reads the same file to the same weights
        jparams = jckpt.torch_state_dict_to_params(jckpt.load_torch_checkpoint(path), params,
                                                   strict=True)
        for k, v in params_from_jax(jparams).items():
            torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)

    # strict keys and shapes
    bad = dict(sd, **{"transformer.unknown.weight": torch.zeros(2)})
    torch.save({"model": bad}, path)
    with pytest.raises(KeyError, match="unknown"):
        ckpt.load_torch_checkpoint(path, dst)
    torch.save({"model": {k: v for k, v in sd.items() if "layer4.0.conv1" not in k}}, path)
    with pytest.raises(KeyError, match="layer4.0.conv1"):
        ckpt.load_torch_checkpoint(path, dst)
    key = "transformer.decoder_layers.0.norm1.weight"
    torch.save({"model": dict(sd, **{key: torch.zeros(7)})}, path)
    with pytest.raises(ValueError, match="norm1"):
        ckpt.load_torch_checkpoint(path, dst)
    kept = ckpt.load_torch_checkpoint(path, dst, skip_mismatched=True)
    assert torch.equal(kept[key], dst.state_dict()[key])
    shutil.rmtree(tmp_path)

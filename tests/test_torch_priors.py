"""The port's spatial priors against the JAX package, on the CPU.

Every (stage, prior) pair the JAX model runs -- learned, grid, defined and
sampled, in stages 1 and 2 -- on a tiny model (1+3 layers, hidden 32, 4
heads, 25 positions x 2 patterns or 20 points x 2 patterns, stage 2 with
``aux_loss``): the same perturbed JAX params mapped into the port by
``params_from_jax``, the same packed uint8 batch with one padded image and
points of which some are invalid. Heads, reference points and every
auxiliary output within 1e-4 (atol and rtol), the tolerance of
tests/test_torch_model.py. Where the JAX model asserts (a points prior
without points) the port raises ValueError.

The learned prior's anchors: ``params_from_jax`` carries the JAX top-level
``position`` to ``transformer.position.weight``, the JAX importer reads
the port's state dict back to the same params, and a reference-layout .pth
carrying ``transformer.position.weight`` imports strictly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train import checkpoints as jckpt

from countdetr_tpu_torch.config import stage1_config, stage2_config
from countdetr_tpu_torch.models.anchor_detr import CountingDetr, build_model
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_checkpoints import reference_pth
from test_torch_model import make_batch, perturb, reference_state_dict

TINY = dict(enc_layers=1, dec_layers=3, hidden_dim=32, nheads=4, dim_feedforward=64,
            num_query_position=25, num_query_pattern=2)
TOL = 1e-4
PRIORS = ("learned", "grid", "defined", "sampled")
PAIRS = [(stage, prior) for stage in (1, 2) for prior in PRIORS]


def configs(stage, prior):
    kw = dict(TINY, spatial_prior=prior)
    if stage == 1:
        return jcfg.stage1_config().model.replace(**kw), stage1_config(**kw)
    return (jcfg.stage2_config().model.replace(aux_loss=True, **kw),
            stage2_config(aux_loss=True, **kw))


def make_inputs(seed, P=20):
    """The packed batch of tests/test_torch_model.py and P points a image,
    the last 6 of image 1 invalid."""
    packed, mask, rects = make_batch(seed)
    rng = np.random.default_rng(50 + seed)
    points = rng.uniform(0.05, 0.9, (2, P, 2)).astype(np.float32)
    valid = np.ones((2, P), bool)
    valid[1, P - 6:] = False
    return dict(images=packed, pad_mask=mask, exemplar_boxes=rects, points=points,
                points_valid=valid)


def jax_call(model, variables, stage, x, with_points=True):
    pts = dict(points=jnp.asarray(x["points"]), points_valid=jnp.asarray(x["points_valid"])) \
        if with_points else {}
    rects = dict(exemplar_boxes=jnp.asarray(x["exemplar_boxes"])) if stage == 2 else {}
    return model.apply(variables, jnp.asarray(x["images"]), jnp.asarray(x["pad_mask"]),
                       **pts, **rects)


def port_args(stage, x, with_points=True):
    names = ("images", "pad_mask") + (("exemplar_boxes",) if stage == 2 else ())
    names += ("points", "points_valid") if with_points else ()
    return [torch.from_numpy(x[k]) for k in names]


@functools.lru_cache(maxsize=None)
def jax_reference(stage, prior):
    """(the JAX model, perturbed params, its forward on one batch)."""
    jc, _ = configs(stage, prior)
    model = JaxCountingDetr(jc)
    x = make_inputs(0)
    variables = jax.jit(lambda k: model.init(
        k, jnp.asarray(x["images"]), jnp.asarray(x["pad_mask"]),
        points=jnp.asarray(x["points"]), points_valid=jnp.asarray(x["points_valid"]),
        **({"exemplar_boxes": jnp.asarray(x["exemplar_boxes"])} if stage == 2 else {})))(
            jax.random.PRNGKey(stage))
    params = perturb(variables, 10 * stage + PRIORS.index(prior))
    want = jax.jit(lambda p, y: jax_call(model, p, stage, y))(params, make_inputs(1))
    return model, params, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("stage,prior", PAIRS, ids=[f"stage{s}-{p}" for s, p in PAIRS])
def test_forward_matches_jax(stage, prior):
    """The heads, the reference points and (stage 2) every decoder layer's
    auxiliary outputs."""
    _, params, want = jax_reference(stage, prior)
    model = build_model(configs(stage, prior)[1], device="cpu",
                        state_dict=params_from_jax(params))
    with torch.inference_mode():
        got = model(*port_args(stage, make_inputs(1)))
    assert set(got) == set(want)
    L = TINY["num_query_position"] * 2 if prior in ("learned", "grid") else 20 * 2
    for key in set(want) - {"aux_outputs"}:
        g, w = got[key].numpy(), want[key]
        assert g.shape == w.shape and g.shape[1] == L and g.dtype == np.float32, key
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=key)
    if stage == 2:
        assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == TINY["dec_layers"] - 1
        for i, (ga, wa) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
            assert set(ga) == set(wa) == {"pred_logits", "pred_boxes"}
            for key in wa:
                np.testing.assert_allclose(ga[key].numpy(), wa[key], atol=TOL, rtol=TOL,
                                           err_msg=f"aux {i} {key}")
        # a caller may drop them: the same last layer, no auxiliary heads
        with torch.inference_mode():
            last = model(*port_args(stage, make_inputs(1)), aux_outputs=False)
        assert "aux_outputs" not in last
        torch.testing.assert_close(last["pred_boxes"], got["pred_boxes"], atol=0, rtol=0)


@pytest.mark.parametrize("stage,prior", [(s, p) for s in (1, 2) for p in ("defined", "sampled")])
def test_points_prior_without_points_raises_as_jax(stage, prior):
    model, params, _ = jax_reference(stage, prior)
    x = make_inputs(2)
    with pytest.raises(AssertionError, match="needs points"):
        jax_call(model, params, stage, x, with_points=False)
    port = build_model(configs(stage, prior)[1], device="cpu", seed=0)
    with torch.inference_mode(), pytest.raises(ValueError, match="needs points"):
        port(*port_args(stage, x, with_points=False))


@pytest.mark.parametrize("stage", [1, 2])
def test_params_from_jax_carries_position(stage):
    """position -> transformer.position.weight, every leaf used once, a
    strict load, and the JAX importer maps the port's weights back to the
    same params (atol 1e-6: the wh bias folded in and out again)."""
    _, params, _ = jax_reference(stage, "learned")
    sd = params_from_jax(params)
    np.testing.assert_array_equal(sd["transformer.position.weight"].numpy(),
                                  np.asarray(params["params"]["position"]))
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    model = CountingDetr(configs(stage, "learned")[1])
    model.load_state_dict(sd, strict=True)
    back = jckpt.torch_state_dict_to_params(reference_state_dict(model), params, strict=True)
    np.testing.assert_array_equal(np.asarray(back["params"]["position"]),
                                  np.asarray(params["params"]["position"]))
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_allclose(np.asarray(flat_back[path]), np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_reference_pth_with_position_imports_strictly(tmp_path):
    """A reference-layout .pth of a learned-prior stage-2 model: the port's
    strict importer and the JAX one read ``transformer.position.weight`` to
    the same anchors; without it the import raises."""
    _, params, _ = jax_reference(2, "learned")
    src = build_model(configs(2, "learned")[1], device="cpu", state_dict=params_from_jax(params))
    path = str(tmp_path / "ref.pth")
    sd = reference_pth(src, path, 2)
    assert "transformer.position.weight" in sd
    dst = build_model(src.cfg, device="cpu", seed=1)
    got = ckpt.load_torch_checkpoint(path, dst)
    torch.testing.assert_close(got["transformer.position.weight"],
                               src.transformer.position.weight.detach(), atol=0, rtol=0)
    dst.load_state_dict(got, strict=True)
    jparams = jckpt.torch_state_dict_to_params(jckpt.load_torch_checkpoint(path), params,
                                               strict=True)
    np.testing.assert_array_equal(np.asarray(jparams["params"]["position"]),
                                  got["transformer.position.weight"].numpy())
    torch.save({"model": {k: v for k, v in sd.items() if k != "transformer.position.weight"}},
               path)
    with pytest.raises(KeyError, match="transformer.position.weight"):
        ckpt.load_torch_checkpoint(path, dst)


def test_seeded_learned_init_is_uniform_in_the_unit_square():
    model = build_model(stage2_config(spatial_prior="learned", num_query_position=300,
                                      num_query_pattern=3, **{k: TINY[k] for k in (
                                          "enc_layers", "dec_layers", "hidden_dim", "nheads",
                                          "dim_feedforward")}), device="cpu", seed=3)
    pos = model.transformer.position.weight.detach()
    assert pos.shape == (300, 2) and pos.min() >= 0 and pos.max() < 1
    assert model.cfg.num_queries == 900

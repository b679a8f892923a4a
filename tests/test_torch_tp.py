"""Tensor parallelism of the port (core/tensor_parallel.py, the (data,
model) mesh of core/mesh.py, the Trainer under ``mesh_axes=("data",
"model")``) against the JAX package and against one port process, on the
CPU.

- The rule table: ``tp_param_spec`` shards the same dimension of every
  parameter as JAX's ``tp_param_spec``, for stage 1 and stage 2, standard
  attention, three levels and the mask head. The JAX params come from
  ``jax.eval_shape`` of each model's init, each leaf filled with its own
  constant, so that ``params_from_jax`` names each port tensor's leaf.
- In one process, for M in {2, 4}: the M model ranks' partial outputs of
  ``RCDAAttention``, ``MHAttention`` and ``FFN``, each built from its
  sliced weights, plus the output bias once, equal the full module within
  1e-6 (float32; only the order of the sums differs); shard then gather is
  bit-equal; the FFN's sharded dropout keeps the full mask's columns.
- One world of 4 processes over gloo, mesh (data=2, model=2), through
  tests/torch_ddp_worker.py (FileStore under tmp_path, killed on failure):
  gloo's all-reduce gives the ranks of a model group the same bytes;
  stage-1 ``pred_wh`` within 2e-5 of JAX's ``model.apply`` (the tolerance
  of JAX's tests/test_tp.py); two stage-2 Trainer steps on global batches
  of 4 within 1e-5 of JAX's loss and optimizer on the global batch (as
  tests/test_torch_ddp.py), and within 1e-5 of one port process,
  ``grad_norm`` included (weights within its Adam bound); the replicated
  parameters bit-equal across each model group; dropout 0.1 on a mesh
  (1, 4) equal to one port process with dropout (one head and 16 hidden
  units a rank); the world's checkpoint, gathered and written by rank 0,
  restores in one process bit-equal to the world's gathered state; a
  one-process checkpoint restores in the world bit-equal.
"""

import copy
import shutil

import jax
import numpy as np
import pytest
import torch

from countdetr_tpu.core import mesh as jmesh

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.core import tensor_parallel as tp
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.models.transformer import FFN, MHAttention, RCDAAttention, dropout
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_ddp import (
    RTOL, World, jax_model_params, jax_reference, save_weights, stage1_global_batch,
    stage2_global_batch,
)
from test_torch_longtail import CASES
from test_torch_longtail import jax_model_params as longtail_params
from torch_ddp_worker import model_config, state_digest

LR = 1e-4
MESH = dict(mesh_shape=(2, 2), mesh_axes=("data", "model"))
STAGE2 = (2, {"num_query_position": 25})
FORWARD_TOL = 2e-5  # JAX's tests/test_tp.py
PARTIAL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread, as in tests/test_torch_ddp.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the rule table


def named_leaves(shapes):
    """The eval_shape'd tree with leaf i filled with the constant i + 1, and
    the JAX spec of each constant."""
    specs = {}

    def fill(path, s):
        specs[len(specs) + 1] = tuple(jmesh.tp_param_spec(path, s))
        return np.full(s.shape, len(specs), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes), specs


@pytest.mark.parametrize("name", ["stage1", "stage2"] + sorted(CASES))
def test_rule_table_matches_jax(name):
    if name.startswith("stage"):
        stage = int(name[-1])
        make = stage2_global_batch if stage == 2 else stage1_global_batch
        shapes = jax.eval_shape(lambda: jax_model_params(stage, make(0), LR)[2])
    else:
        shapes = jax.eval_shape(lambda: longtail_params(name)[1])
    filled, specs = named_leaves(shapes)
    state = params_from_jax(filled)
    assert len(state) == len(specs)
    sharded = 0
    for key, t in state.items():
        want = specs[int(t.reshape(-1)[0])]
        assert tp.tp_param_spec(key, t) == want, key
        sharded += bool(want)
    assert sharded > 0


def test_layout_refuses_a_head_count_the_axis_does_not_divide():
    with pytest.raises(ValueError, match="nheads 4 is not a multiple of the model axis 3"):
        tp.shard_model_(MHAttention(24, 4), 0, 3)
    with pytest.raises(ValueError, match="dim_feedforward 64 is not a multiple"):
        tp.shard_model_(FFN(32, 64), 0, 3)


# ---------------------------------------------------------------- one process


def blocks(seed):
    """The three sharded blocks at E=32, 4 heads, F=64, with random weights
    and biases, and inputs for each."""
    g = torch.Generator().manual_seed(seed)
    rcda, mha, ffn = RCDAAttention(32, 4), MHAttention(32, 4), FFN(32, 64, dropout=0.1)
    with torch.no_grad():
        for m in (rcda, mha, ffn):
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    r = lambda *s: torch.randn(*s, generator=g)
    grid, q, k = r(2, 5, 6, 32), r(2, 7, 32), r(2, 9, 32)
    pad = torch.zeros(2, 5, 6, dtype=torch.bool)
    pad[1, 3:] = True
    pad[1, :, 4:] = True
    key_pad = torch.zeros(2, 9, dtype=torch.bool)
    key_pad[0, 6:] = True
    return {"rcda": (rcda, (q, q + 1, grid, grid * 2, grid, pad)),
            "mha": (mha, (q, k, k * 2, key_pad)),
            "ffn": (ffn, (q,))}


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("kind", ["rcda", "mha", "ffn"])
def test_partial_outputs_sum_to_the_full_block(kind, M):
    """Each model rank's share from its sliced weights (the FFN with its
    dropout at 0.1 from equal generator states), summed, plus the output
    bias once."""
    module, args = blocks(3)[kind]
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    extra = {"generator": gen()} if kind == "ffn" else {}
    with torch.no_grad():
        want = module.partial(*args, **extra)
        parts = []
        for m in range(M):
            shard = copy.deepcopy(module)
            layout = tp.shard_model_(shard, m, M)
            extra = {"generator": gen()} if kind == "ffn" else {}
            parts.append(shard.partial(*args, bias=False, **extra))
        bias = module.linear2.bias if kind == "ffn" else module.out_proj.bias
        got = torch.stack(parts).sum(0) + bias
    assert layout and shard.tp == tp.ModelShard(M - 1, M)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=PARTIAL_TOL)


@pytest.mark.parametrize("M", [2, 4])
def test_shard_then_gather_is_bit_equal(M):
    """Every sharded tensor of a model with both attention types and the
    FFN, cut into M shards by ``shard_state`` and put back by ``assemble``;
    the heads of each role land on their rank."""
    full = {f"{kind}.{k}": v for kind, (m, _) in blocks(4).items()
            for k, v in m.state_dict().items()}
    layout = tp.tp_layout(full)
    assert set(layout) == {"rcda.in_proj_weight", "rcda.in_proj_bias", "rcda.out_proj.weight",
                           "mha.in_proj_weight", "mha.in_proj_bias", "mha.out_proj.weight",
                           "ffn.linear1.weight", "ffn.linear1.bias", "ffn.linear2.weight"}
    assert layout["rcda.in_proj_weight"] == (0, 5) and layout["mha.in_proj_bias"] == (0, 3)
    shards = [tp.shard_state(full, m, M) for m in range(M)]
    assert tp.tp_layout(shards[0], M) == layout
    for k, v in full.items():
        if k not in layout:
            assert all(s[k] is v for s in shards)
            continue
        got = tp.assemble([s[k] for s in shards], *layout[k])
        assert torch.equal(got, v), k
    # rank 1's rows of RCDA's packed projection: its heads of each role
    E, w = 32, shards[1]["rcda.in_proj_weight"]
    for role in range(5):
        lo = role * E + E // M
        assert torch.equal(w[role * E // M:(role + 1) * E // M],
                           full["rcda.in_proj_weight"][lo:lo + E // M])


@pytest.mark.parametrize("M", [2, 4])
def test_sharded_dropout_keeps_the_full_masks_columns(M):
    """And leaves the generator where the full mask leaves it."""
    x = torch.ones(3, 4, 8 * M)
    g_full = torch.Generator().manual_seed(5)
    full = dropout(x, 0.3, g_full)
    for m in range(M):
        g = torch.Generator().manual_seed(5)
        got = dropout(x[..., :8], 0.3, g, tp.ModelShard(m, M))
        assert torch.equal(got, full[..., m * 8:(m + 1) * 8])
        assert torch.equal(g.get_state(), g_full.get_state())


# ---------------------------------------------------------------- a world of 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4 on its tasks, with the JAX side and the one-process
    side computed while it runs."""
    tmp = tmp_path_factory.mktemp("tp")
    s1 = [stage1_global_batch(0)]
    s2 = [stage2_global_batch(0), stage2_global_batch(1)]
    jm1, _, p1 = jax_model_params(1, s1[0], LR)
    jm2, cfg2, p2 = jax_model_params(2, s2[0], LR)
    w1 = save_weights(tmp / "w1.pt", params_from_jax(p1))
    w2_state = params_from_jax(p2)
    w2 = save_weights(tmp / "w2.pt", w2_state)
    train = dict(lr=LR, exact_match=True)
    # the one-process checkpoint the world restores: a step, so moments exist
    one_ckpt = Trainer(model_config(STAGE2), TrainConfig(**train), device="cpu",
                       state_dict=w2_state)
    one_ckpt.step(stage2_global_batch(7))
    ckpt.save_checkpoint(str(tmp / "from_one"), 0, one_ckpt, {"epoch": 0})
    from_one = state_digest(one_ckpt.state_dict())
    dropout_model = (2, {"num_query_position": 25, "dropout": 0.1})
    w = World(tmp, [
        dict(kind="allreduce", mesh=(2, 2), n=4099),
        dict(kind="forward", mesh=(2, 2), model=(1, {}), weights=w1, batch=s1[0],
             inputs=("images", "pad_mask", "points", "points_valid"), keep=("pred_wh",)),
        dict(kind="steps", model=STAGE2, train=dict(train, **MESH), weights=w2, batches=s2,
             save=str(tmp / "from_tp"), keep_model=True),
        dict(kind="steps", model=dropout_model,
             train=dict(train, mesh_shape=(1, 4), mesh_axes=("data", "model")),
             weights=w2, batches=s2),
        dict(kind="steps", model=STAGE2, train=dict(train, **MESH),
             restore=str(tmp / "from_one"), batches=s2[:1])], world=4)
    x = s1[0]
    want_wh = np.asarray(jax.jit(jm1.apply)(p1, x["images"], x["pad_mask"], x["points"],
                                            x["points_valid"])["pred_wh"])
    want_jax = jax_reference(2, jm2, cfg2, p2, s2)
    single = Trainer(model_config(STAGE2), TrainConfig(**train), device="cpu",
                     state_dict=w2_state)
    one = [{k: float(v) for k, v in single.step(b).items()} for b in s2]
    drop = Trainer(model_config(dropout_model), TrainConfig(**train), device="cpu",
                   state_dict=w2_state)
    one_dropout = [{k: float(v) for k, v in drop.step(b).items()} for b in s2]
    results = w.join()
    yield dict(tmp=tmp, results=results, want_wh=want_wh, want_jax=want_jax, one=one,
               one_model=single.model.state_dict(), one_dropout=one_dropout,
               from_one=from_one, train=train)
    shutil.rmtree(tmp, ignore_errors=True)  # weights and checkpoints


def test_gloo_all_reduce_gives_a_model_group_the_same_bytes(world):
    got = [res[0] for res in world["results"]]
    assert got[0] == got[1] and got[2] == got[3]
    assert got[0] != got[2]  # the two model groups summed different tensors


def test_forward_matches_jax(world):
    parts = [world["results"][r][1]["pred_wh"] for r in range(4)]
    np.testing.assert_array_equal(parts[0], parts[1])  # a model group's replicas
    np.testing.assert_array_equal(parts[2], parts[3])
    got = np.concatenate([parts[0], parts[2]])
    np.testing.assert_allclose(got, world["want_wh"], atol=FORWARD_TOL, rtol=0)


def test_train_step_matches_jax_and_one_process(world):
    for rank, res in enumerate(world["results"]):
        out = res[2]
        for i, (got, jx, one) in enumerate(zip(out["metrics"], world["want_jax"],
                                               world["one"])):
            assert set(got) == set(jx) == set(one)
            for k in jx:
                np.testing.assert_allclose(got[k], jx[k], rtol=RTOL,
                                           err_msg=f"JAX: rank {rank} step {i} {k}")
                np.testing.assert_allclose(got[k], one[k], rtol=RTOL,
                                           err_msg=f"one process: rank {rank} step {i} {k}")
    got, want = world["results"][0][2]["model"], world["one_model"]
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2 * 2 * LR,
                                   err_msg=k)


def test_replicated_params_bit_equal_across_each_model_group(world):
    params = dict(build_model(model_config(STAGE2), device="cpu").named_parameters())
    n_replicated = len(params) - len(tp.tp_layout(params))
    for task in (2, 3, 4):
        rep = [res[task]["replicated"] for res in world["results"]]
        assert rep[0] == rep[1] and rep[2] == rep[3], task
        assert len(rep[0]) == n_replicated
        states = [res[task]["state"] for res in world["results"]]
        assert all(s == states[0] for s in states), task  # gathered: every rank the same


def test_dropout_matches_one_process(world):
    for rank, res in enumerate(world["results"]):
        for i, (got, want) in enumerate(zip(res[3]["metrics"], world["one_dropout"])):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=f"rank {rank} step {i} {k}")
    # dropout moved the losses: the masks were drawn
    assert world["one_dropout"][0]["loss"] != world["one"][0]["loss"]


def test_checkpoints_cross_between_the_world_and_one_process(world):
    directory = str(world["tmp"] / "from_tp")
    step = ckpt.latest_step(directory)
    assert step == 2
    trainer = Trainer(model_config(STAGE2), TrainConfig(**world["train"]), device="cpu",
                      seed=99)
    ckpt.restore_checkpoint(directory, step, trainer)
    assert state_digest(trainer.state_dict()) == world["results"][0][2]["state"]
    for res in world["results"]:
        assert res[4]["restored"] == world["from_one"]

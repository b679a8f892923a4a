"""Data parallelism of the port (core/mesh.py, the Batcher's global
schedule, global loss normalisers, rank-safe checkpoints) against the JAX
package and against one port process, on the CPU.

Worlds of 2 processes run tests/torch_ddp_worker.py over gloo; they meet at
a FileStore under the test's tmp_path (no TCP port, so concurrent test
workers cannot collide). Each world has a join timeout of 120 s and its
processes are killed on failure.

- The Batcher's slices equal the JAX Batcher's for process_count 1, 2
  and 3: three shuffled epochs with box tiers, an uneven dataset where a
  rank's tail slice is all padding, and the port's worker pool.
- ``_weighted_reduce`` is the JAX package's bit for bit (a NaN on a
  zero-weight row is dropped, one on a weighted row propagates), and
  ``gather_metrics`` in a world of 2 equals JAX's reduce of the same
  vectors.
- A world of 2 trains stage 2, then stage 1, for 2 steps each on its
  slices of global batches of 4, against the JAX package's loss and
  optimizer on the whole global batch (its ``stage2_loss``/``stage1_loss``,
  ``build_optimizer`` and ``value_and_grad``, as ``make_train_step`` runs
  them, plus the gradient norm over the trainable leaves: JAX's
  ``grad_norm`` also counts the frozen ones): every loss part and the
  gradient norm within 1e-5 relative, float32, both sides matching by the
  exact LAP. The ranks' valid and matched counts differ (45 and 10 matched
  targets in stage 2; 28 and 3 valid points in stage 1), so per-rank
  normalisers, or a per-rank matched mean of the variance term, would be
  off by far more.
- A world of 2 restores a checkpoint written by one process, takes 4 steps
  against that process taking the same 4 global batches (losses and
  gradient norms within 1e-5 relative; weights within 2 * steps * lr, the
  bound of tests/test_torch_train.py: Adam moves a weight whose gradient is
  float32 noise by up to lr a step either way), and writes a checkpoint
  that one process restores bit-equal to both ranks' states (sha256 of
  every tensor, so no state crosses between processes); then it runs
  the uneven 5-sample epoch (two global batches of 4; rank 1's second
  slice is all padding), which ends on both ranks with the one-process
  epoch's losses (the JAX package's test_two_process_lockstep_on_uneven_dataset).
- The backend and device rule, the mesh check and the CLI's refusal of
  its inference modes in a world.
"""

import os
import pickle
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.core import mesh as jmesh
from countdetr_tpu.data import batching as jbatching
from countdetr_tpu.data import fscd147 as jfscd
from countdetr_tpu.models import CountingDetr as JaxCountingDetr
from countdetr_tpu.train import train_step as jstep
from countdetr_tpu.train.optimizer import _label
from countdetr_tpu.train.optimizer import build_optimizer as jax_build_optimizer

from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.core import mesh
from countdetr_tpu_torch.data import batching, fscd147
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from countdetr_tpu_torch.train import checkpoints as ckpt
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_data import assert_batches_equal
from test_torch_longtail import fill_params
from torch_ddp_worker import TINY, SynthStage1, model_config, state_digest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_ddp_worker.py")
JOIN_TIMEOUT_S = 120
RTOL = 1e-5
TREE = dict(n_train=7, n_val=2, n_test=2, size=(96, 128), objects=(3, 20), seed=3)
BUCKETS = ((96, 128), (128, 128))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models, dispatch more than arithmetic: one intra-op thread
    spares the port's side the thread pool's cost while the suite's other
    workers hold every core (as in tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class World:
    """``world`` worker processes started on ``tasks``; ``join`` returns
    their results by rank. A process that fails or outlives the join
    timeout fails the test, and every process still running is killed.
    The caller works on its side while the world runs."""

    def __init__(self, tmp_path, tasks, world=2):
        self.tmp, self.procs, self.logs = tmp_path, [], []
        self.deadline = time.time() + JOIN_TIMEOUT_S
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for rank in range(world):
            spec = dict(rank=rank, world=world, store=str(tmp_path / "store"),
                        out=str(tmp_path / f"out{rank}.pkl"), tasks=tasks)
            path = tmp_path / f"spec{rank}.pkl"
            path.write_bytes(pickle.dumps(spec))
            self.logs.append(open(tmp_path / f"rank{rank}.log", "w"))
            self.procs.append(subprocess.Popen([sys.executable, WORKER, str(path)],
                                               stdout=self.logs[-1], stderr=subprocess.STDOUT,
                                               env=env))

    def join(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        for rank, p in enumerate(self.procs):
            tail = (self.tmp / f"rank{rank}.log").read_text()[-3000:]
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{tail}"
        return [pickle.loads((self.tmp / f"out{rank}.pkl").read_bytes())
                for rank in range(len(self.procs))]


def save_weights(path, state_dict):
    """The weights the ranks load, written once (a tiny model's are ~100 MB)."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return str(path)


# ---------------------------------------------------------------- the Batcher


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_fscd147(str(tmp_path_factory.mktemp("ddp_tree")), **TREE)


def batcher_pair(root, pc, rank, bs, num_workers=0, **kw):
    ds, jds = fscd147.FSC147Pseudo(root, "train"), jfscd.FSC147Pseudo(root, "train")
    ds.host_normalize = jds.host_normalize = False
    kw.update(max_boxes=12, pack_s2d=True, process_index=rank, process_count=pc)
    return (batching.Batcher(ds, bs, BUCKETS, num_workers=num_workers, **kw),
            jbatching.Batcher(jds, bs, BUCKETS, num_workers=0, **kw))


@pytest.mark.parametrize("pc", [1, 2, 3])
def test_shuffled_slices_match_jax(tree, pc):
    """Three shuffled epochs with box tiers, each rank's batches."""
    for rank in range(pc):
        got_b, want_b = batcher_pair(tree, pc, rank, 2, box_tiers=(4, 12, 96), shuffle=True,
                                     seed=5)
        for _ in range(3):
            assert got_b.num_batches() == want_b.num_batches()
            assert got_b._schedule() == want_b._schedule()
            assert_batches_equal(list(got_b), list(want_b))


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("pc", [1, 2, 3])
def test_uneven_slices_match_jax(tree, pc, num_workers):
    """7 samples at 3 a rank: with 2 ranks the second global batch holds
    one real sample, and rank 1's slice of it is all padding."""
    slices = []
    for rank in range(pc):
        got_b, want_b = batcher_pair(tree, pc, rank, 3, num_workers)
        try:
            got = list(got_b)
        finally:
            got_b.close()
        assert_batches_equal(got, list(want_b))
        slices.append([b["batch_valid"] for b in got])
    assert [sum(int(v.sum()) for r in slices for v in r)] == [TREE["n_train"]]
    if pc == 2:
        assert not slices[1][-1].any() and slices[0][-1].sum() == 1


# ---------------------------------------------------------------- metrics


def test_weighted_reduce_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(4, 6)).astype(np.float32)
    rows[:, -1] = [3.0, 0.0, 1e5, 7.0]  # weights; the second row is all padding
    rows[1, 2] = np.nan  # dropped: weight 0
    cases = [rows, rows.copy()]
    cases[1][3, 0] = np.nan  # propagates: weight 7
    for a in cases:
        got, want = mesh._weighted_reduce(a), jmesh._weighted_reduce(a)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(mesh._weighted_reduce(cases[0])).all()
    assert np.isnan(mesh._weighted_reduce(cases[1])[0])


# ---------------------------------------------------------------- against JAX


def stage2_global_batch(seed, valid=(20, 31, 7, 3), T=32):
    """4 images of 64x96 (image 1 padded), 3 exemplars, T targets of which
    ``valid`` are real (small ones in images 0-1, large ones in 2-3); 25
    queries, so image 1's 31 match 25."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    mask = np.zeros((4, 64, 96), bool)
    mask[1, 48:] = True
    mask[1, :, 80:] = True
    raw[mask] = 0
    rects = rng.uniform(0.05, 0.5, (4, 3, 4)).astype(np.float32)
    rects[..., 2:] = rects[..., :2] + rng.uniform(0.1, 0.3, (4, 3, 2))
    boxes = rng.uniform(0.2, 0.7, (4, T, 4)).astype(np.float32)
    # rank 0's targets small, rank 1's large: the ranks' matched means of
    # (w, h) differ, so a per-rank mean moves the variance loss
    boxes[:2, :, 2:] = rng.uniform(0.02, 0.1, (2, T, 2))
    boxes[2:, :, 2:] = rng.uniform(0.2, 0.4, (2, T, 2))
    return dict(images=batching.pack_space_to_depth(raw), pad_mask=mask, exemplar_boxes=rects,
                boxes=boxes, boxes_valid=np.arange(T)[None] < np.asarray(valid)[:, None],
                batch_valid=np.ones(4, bool))


def stage1_global_batch(seed, valid=(12, 16, 3, 0), P=16):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    mask = np.zeros((4, 64, 96), bool)
    mask[0, :, 64:] = True
    raw[mask] = 0
    points = rng.uniform(0.05, 0.6, (4, P, 2)).astype(np.float32)
    return dict(images=batching.pack_space_to_depth(raw), pad_mask=mask, points=points,
                points_valid=np.arange(P)[None] < np.asarray(valid)[:, None],
                whs=rng.uniform(0.03, 0.3, (4, P, 2)).astype(np.float32),
                batch_valid=np.ones(4, bool))


def jax_model_params(stage, batch, lr):
    """The tiny JAX model of ``stage``, its config and params (from
    ``jax.eval_shape`` and a numpy fill)."""
    base = jcfg.stage1_config() if stage == 1 else jcfg.stage2_config()
    jm = base.model.replace(**TINY, **({} if stage == 1 else {"num_query_position": 25}))
    cfg = base.replace(model=jm, train=base.train.replace(lr=lr, exact_match=True))
    model = JaxCountingDetr(jm)
    b0 = {k: jnp.asarray(v) for k, v in batch.items()}
    args = ((b0["images"], b0["pad_mask"], b0["points"], b0["points_valid"]) if stage == 1
            else (b0["images"], b0["pad_mask"]))
    kw = {} if stage == 1 else {"exemplar_boxes": b0["exemplar_boxes"]}
    return model, cfg, fill_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args,
                                                  **kw), 7)


def jax_reference(stage, model, cfg, params, batches):
    """The JAX package's loss parts and trainable gradient norm at each of
    ``batches`` (global), stepping its optimizer from ``params``."""
    tx = jax_build_optimizer(cfg.train, params, steps_per_epoch=1)
    loss_fn = jstep.stage1_loss if stage == 1 else jstep.stage2_loss

    @jax.jit
    def step(p, opt_state, batch):
        if stage == 2:
            batch = jstep._prepare_stage2_batch(batch)
        (_, parts), grads = jax.value_and_grad(
            lambda q: loss_fn(model, q, batch, cfg), has_aux=True)(p)
        parts["grad_norm"] = optax.global_norm(jax.tree_util.tree_map_with_path(
            lambda path, g: jnp.zeros_like(g) if _label(path) == "frozen" else g, grads))
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, parts

    p, opt_state, out = params, tx.init(params), []
    for b in batches:
        p, opt_state, parts = step(p, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in parts.items()})
    return out


@pytest.mark.parametrize("stage", [2, 1])
def test_world_of_two_matches_jax_global_batch(tmp_path, stage):
    lr = 1e-4
    make = stage2_global_batch if stage == 2 else stage1_global_batch
    batches = [make(0), make(1)]
    jmodel, cfg, params = jax_model_params(stage, batches[0], lr)
    world = World(tmp_path, [dict(
        kind="steps", model=(stage, {} if stage == 1 else {"num_query_position": 25}),
        train=dict(lr=lr, exact_match=True), batches=batches,
        weights=save_weights(tmp_path / "weights.pt", params_from_jax(params)))])
    want = jax_reference(stage, jmodel, cfg, params, batches)
    results = world.join()
    os.remove(tmp_path / "weights.pt")
    for rank, res in enumerate(results):
        for i, (got, w) in enumerate(zip(res[0]["metrics"], want)):
            assert set(got) == set(w)
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=RTOL,
                                           err_msg=f"rank {rank} step {i} {k}")


# ---------------------------------------------------------------- one process


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """One port process and a world of 2 on the same global batches: the
    world restores the process's checkpoint, takes 4 steps, writes a
    checkpoint, then runs the uneven 5-sample epoch."""
    tmp = tmp_path_factory.mktemp("lockstep")
    model = (1, {})
    train = dict(lr=1e-4)
    single = Trainer(model_config(model), TrainConfig(**train), device="cpu", seed=4)
    single.step(stage1_global_batch(9))  # moments and a scheduler position to restore
    ckpt.save_checkpoint(str(tmp / "from_one"), 0, single, {"epoch": 0})
    start = state_digest(single.state_dict())
    batches = [stage1_global_batch(10 + i, valid=(16, 5, 9, 1)) for i in range(4)]
    epoch_trainer = Trainer(model_config(model), TrainConfig(**train), device="cpu", seed=4)
    weights = save_weights(tmp / "weights.pt", epoch_trainer.model.state_dict())
    gather = dict(kind="gather", metrics=[{"loss": 0.25, "b": np.nan, "c": 1e-3},
                                         {"loss": 1.75, "b": 2.5, "c": 3e3}],
                  weights=[0.0, 3.0])
    world = World(tmp, [
        gather,
        dict(kind="steps", model=model, train=train, restore=str(tmp / "from_one"),
             batches=batches, save=str(tmp / "from_two"), keep_model=True),
        dict(kind="epoch", model=model, train=train, weights=weights, n=5, bs=2)])
    metrics = [{k: float(v) for k, v in single.step(b).items()} for b in batches]
    one_epoch = engine_epoch(epoch_trainer, 5, 4)
    results = world.join()
    yield dict(tmp=tmp, start=start, single=single, metrics=metrics, batches=batches,
               results=results, gather=gather, one_epoch=one_epoch)
    shutil.rmtree(tmp, ignore_errors=True)  # ~0.7 GB of checkpoints and weights


def engine_epoch(trainer, n, bs):
    from countdetr_tpu_torch.train import engine

    batcher = batching.Batcher(SynthStage1(n), bs, [(64, 96)], max_points=3, pack_s2d=True)
    losses = []
    step = trainer.step

    def logged(batch):
        out = step(batch)
        losses.append(float(out["loss"]))
        return out

    trainer.step = logged
    return losses, engine.train_one_epoch(trainer, batcher, 0, log_every=1)


def test_gather_metrics_matches_jax_reduce(lockstep):
    g = lockstep["gather"]
    keys = sorted(g["metrics"][0])
    rows = np.array([[float(m[k]) for k in keys] + [w] for m, w in
                     zip(g["metrics"], g["weights"])], np.float32)
    want = dict(zip(keys, jmesh._weighted_reduce(rows).tolist()))
    for res in lockstep["results"]:
        assert res[0] == want
    assert want["b"] == 2.5  # the zero-weight rank's NaN is dropped


def test_world_of_two_matches_one_process(lockstep):
    lr, steps = 1e-4, len(lockstep["batches"])
    for rank, res in enumerate(lockstep["results"]):
        out = res[1]
        assert out["restored"] == lockstep["start"]
        for i, (got, want) in enumerate(zip(out["metrics"], lockstep["metrics"])):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=f"rank {rank} step {i} {k}")
    single = lockstep["single"].model.state_dict()
    got = lockstep["results"][0][1]["model"]
    assert set(got) == set(single)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), single[k].numpy(), rtol=0, atol=2 * steps * lr,
                                   err_msg=k)
    # DDP averaged the same gradients into the same update on both ranks
    assert lockstep["results"][0][1]["state"] == lockstep["results"][1][1]["state"]


def test_checkpoint_of_a_world_restores_in_one_process(lockstep):
    directory = str(lockstep["tmp"] / "from_two")
    step = ckpt.latest_step(directory)
    assert step == 1 + len(lockstep["batches"])  # the restored step and the world's four
    trainer = Trainer(model_config((1, {})), TrainConfig(lr=1e-4), device="cpu", seed=99)
    meta = ckpt.restore_checkpoint(directory, step, trainer)
    assert meta["epoch"] == 0 and meta["opt_step"] == step
    for res in lockstep["results"]:
        assert state_digest(trainer.state_dict()) == res[1]["state"]
    assert not any(k.startswith("module.") for k in trainer.state_dict()["model"])


def test_uneven_epoch_ends_on_both_ranks(lockstep):
    want_losses, want_stats = lockstep["one_epoch"]
    assert len(want_losses) == 2  # ceil(5 / 4): the tail batch trains too
    for res in lockstep["results"]:
        out = res[2]
        assert out["bad_steps"] == 0 and out["stats"]["steps"] == 2
        np.testing.assert_allclose(out["losses"], want_losses, rtol=RTOL)
        assert np.isfinite(out["losses"]).all()
    # rank 0: 2 + 1 real samples; rank 1: 2 + 0 (its tail slice is padding)
    assert [r[2]["stats"]["real_samples"] for r in lockstep["results"]] == [3, 2]
    assert want_stats["real_samples"] == 5


# ---------------------------------------------------------------- topology


def test_backend_and_device_rule(monkeypatch):
    assert mesh.select_backend("cpu", 1) == mesh.select_backend("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.select_backend("cuda", 2) == "nccl"
    assert mesh.select_backend("cuda", 4) == "gloo"  # ranks would share a card
    assert mesh.local_device("cuda", rank=3) == torch.device("cuda", 1)
    assert mesh.local_device("cuda:0", rank=3) == torch.device("cuda", 0)
    assert mesh.local_device("cuda") == torch.device("cuda")  # one process
    assert mesh.local_device("cpu", rank=1) == torch.device("cpu")


def test_check_mesh_axes():
    """("data",) and ("data", "model") are the meshes; a shape must span the
    world, -1 filling one slot; every other axis set is refused."""
    mesh.check_mesh((-1,), ("data",))
    mesh.check_mesh((1,), ("data",))
    mesh.check_mesh((1, 1), ("data", "model"))
    mesh.check_mesh((-1, 1), ("data", "model"))
    assert mesh.mesh_dims((-1,), ("data",), world=3) == (3, 1)
    assert mesh.mesh_dims((2, -1), ("data", "model"), world=8) == (2, 4)
    assert mesh.mesh_dims((-1, 4), ("data", "model"), world=8) == (2, 4)
    assert mesh.mesh_dims((1, 4), ("data", "model"), world=4) == (1, 4)
    for axes in (("batch",), ("model",), ("model", "data"), ("data", "model", "seq")):
        with pytest.raises(SystemExit, match="the port's meshes"):
            mesh.check_mesh((1,) * len(axes), axes)
    with pytest.raises(SystemExit, match="spans the 1 process"):
        mesh.check_mesh((2,), ("data",))
    with pytest.raises(SystemExit, match="spans the 8 process"):
        mesh.mesh_dims((2, 2), ("data", "model"), world=8)
    with pytest.raises(SystemExit, match="3 does not divide the 8"):
        mesh.mesh_dims((-1, 3), ("data", "model"), world=8)
    with pytest.raises(SystemExit, match="one size a mesh axis"):
        mesh.check_mesh((1,), ("data", "model"))
    with pytest.raises(SystemExit, match="one size a mesh axis"):
        mesh.check_mesh((-1, -1), ("data", "model"))
    with pytest.raises(SystemExit, match="spans the 1 process"):
        Trainer(model_config((1, {})), TrainConfig(mesh_shape=(1, 2),
                                                   mesh_axes=("data", "model")), device="cpu")


@pytest.mark.parametrize("mode", ["--infer", "--test", "--generate_pseudo_label"])
def test_cli_refuses_inference_modes_in_a_world(tree, tmp_path, monkeypatch, mode):
    from countdetr_tpu_torch.cli import main as tmain

    monkeypatch.setattr(tmain, "process_count", lambda: 2)
    args = tmain.get_args_parser().parse_args(
        ["--data_path", tree, "--output_dir", str(tmp_path), "--device", "cpu", "--stage", "2",
         "--spatial_prior", "grid", "--num_query_position", "25", "--num_query_pattern", "1",
         mode])
    with pytest.raises(SystemExit, match="no process stride"):
        tmain.main(args)

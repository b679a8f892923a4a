"""One rank of a data-parallel world of the port, started by
tests/test_torch_ddp.py on the CPU (gloo). It imports torch and the port,
never JAX.

    python tests/torch_ddp_worker.py SPEC.pkl

SPEC is a pickled dict: ``rank``, ``world``, ``store`` (the FileStore
path the world meets at), ``out`` (where this rank pickles its results)
and ``tasks``, run in order, each a dict with a ``kind``:

  gather   ``gather_metrics(task["metrics"][rank], task["weights"][rank])``
  steps    a distributed Trainer (``model``: stage and ModelConfig
           overrides, ``train``: TrainConfig keywords, weights from the
           ``weights`` file (a torch.save'd state_dict) or a checkpoint
           ``restore`` directory) takes a step on this rank's rows of each of
           the global ``batches``; records each step's metrics and the
           digests of the Trainer's state after the restore and at the end
           (``state_digest``), rank 0 its final weights when ``keep_model``,
           and with ``save`` writes a checkpoint there
  epoch    train_one_epoch over a Batcher with the process stride on
           ``SynthStage1(n)`` at batch size ``bs``; records the per-step
           losses (through the Trainer's metrics) and the stats
"""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from countdetr_tpu_torch.config import TrainConfig, stage1_config, stage2_config  # noqa: E402
from countdetr_tpu_torch.core import mesh  # noqa: E402
from countdetr_tpu_torch.data.batching import Batcher  # noqa: E402
from countdetr_tpu_torch.train import checkpoints as ckpt  # noqa: E402
from countdetr_tpu_torch.train import engine  # noqa: E402
from countdetr_tpu_torch.train.train_step import Trainer  # noqa: E402

TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64)


class SynthStage1:
    """Deterministic stage-1 samples in one 64x96 bucket, points and their
    w, h: the counterpart of the JAX package's tests/mp_train_child.py
    dataset, as raw uint8 images."""

    def __init__(self, n: int, points: int = 3):
        self.n, self.points = n, points

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        return {"image": rng.integers(0, 256, (64, 96, 3), dtype=np.uint8),
                "points": rng.uniform(0.2, 0.8, (self.points, 2)).astype(np.float32),
                "whs": rng.uniform(0.1, 0.3, (self.points, 2)).astype(np.float32),
                "orig_size": (96, 64), "image_name": f"{i}.jpg"}

    def image_size(self, i):
        return (64, 96)


def model_config(spec):
    stage, kw = spec
    return (stage1_config if stage == 1 else stage2_config)(**{**TINY, **kw})


def trainer_for(task):
    weights = torch.load(task["weights"]) if task.get("weights") else None
    trainer = Trainer(model_config(task["model"]), TrainConfig(**task["train"]), device="cpu",
                      state_dict=weights, steps_per_epoch=task.get("spe", 1), distributed=True)
    if task.get("restore"):
        ckpt.restore_checkpoint(task["restore"], ckpt.latest_step(task["restore"]), trainer)
    return trainer


def state_digest(state):
    """sha256 of the bytes of each tensor of a (nested) Trainer state, by key
    path, and the other leaves as they are: equal digests are a bit-equal
    state, without moving the state between processes."""
    import hashlib

    def flat(obj, prefix=""):
        if isinstance(obj, dict):
            return [x for k, v in obj.items() for x in flat(v, f"{prefix}/{k}")]
        if isinstance(obj, (list, tuple)):
            return [x for i, v in enumerate(obj) for x in flat(v, f"{prefix}/{i}")]
        return [(prefix, obj)]

    out = {}
    for k, v in flat(state):
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            out[k] = f"{t.dtype}{tuple(t.shape)}" + hashlib.sha256(
                t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
        else:
            out[k] = repr(v)
    return out


def run(task, rank, world):
    if task["kind"] == "gather":
        return mesh.gather_metrics(dict(task["metrics"][rank]), task["weights"][rank])
    if task["kind"] == "steps":
        trainer = trainer_for(task)
        restored = state_digest(trainer.state_dict())
        metrics = []
        for batch in task["batches"]:
            bs = len(batch["images"]) // world
            mine = {k: v[rank * bs:(rank + 1) * bs] for k, v in batch.items()}
            metrics.append({k: float(v) for k, v in trainer.step(mine).items()})
        if task.get("save"):
            ckpt.save_checkpoint(task["save"], trainer.scheduler.last_epoch, trainer,
                                 {"epoch": 0})
        model = None
        if task.get("keep_model") and rank == 0:
            model = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        return {"metrics": metrics, "restored": restored,
                "state": state_digest(trainer.state_dict()), "model": model}
    if task["kind"] == "epoch":
        trainer = trainer_for(task)
        batcher = Batcher(SynthStage1(task["n"]), task["bs"], [(64, 96)], max_points=3,
                          pack_s2d=True, process_index=rank, process_count=world)
        losses = []
        step = trainer.step

        def logged(batch):
            out = step(batch)
            losses.append(float(out["loss"]))
            return out

        trainer.step = logged
        stats = engine.train_one_epoch(trainer, batcher, 0, log_every=1)
        return {"losses": losses, "stats": stats, "bad_steps": int(trainer.bad_steps)}
    raise ValueError(task["kind"])


def main():
    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    rank, world = spec["rank"], spec["world"]
    mesh.init_distributed("cpu", init_method=f"file://{spec['store']}", rank=rank,
                          world_size=world, timeout_s=spec.get("timeout_s", 100))
    results = [run(task, rank, world) for task in spec["tasks"]]
    with open(spec["out"] + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(spec["out"] + ".tmp", spec["out"])
    mesh.shutdown()


if __name__ == "__main__":
    main()

"""The port's measuring tool (countdetr_tpu/cli/bench.py; the reference's
compute_flops_and_speeds.py): one JSON line a mode, with the JAX tool's
keys and the device the numbers were taken on.

    python -m countdetr_tpu_torch.cli.bench --mode flops [--stage 2] [--size 592]
    python -m countdetr_tpu_torch.cli.bench --mode train [--batch 8] [--queries 600] \\
        [--max_boxes 700] [--size 592]
    python -m countdetr_tpu_torch.cli.bench --mode e2e [--num_workers 2] [--n_images 64] \\
        [--decoded_cache | --decoded_cache_dir DIR]
    python -m countdetr_tpu_torch.cli.bench --mode match [--batch 8] [--plain_auction]

flops: the FLOPs of one forward at ``--size``, batch 1, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain PyTorch path on
  the CPU (the hand-written kernels are ctypes calls no counter sees). It
  counts the matrix products (convolutions, linears, the attention cores'
  einsums and bmms) at 2 per multiply-add and nothing elementwise;
  ``bytes_accessed_gb`` sums every operator's inputs and outputs, unfused.
  XLA's ``cost_analysis`` in the JAX tool counts after fusion and includes
  elementwise work, so the two tools' numbers differ by construction.
train: stage 1 or 2 at --size/--batch/--queries/--max_boxes on random
  images and targets; ``Trainer.step`` timed by CUDA events over --iters
  steps after a warm step (the host clock on the CPU).
e2e: stage 2 on a synthetic FSCD-147 tree (data/synthetic.py): FSC147Pseudo,
  the shuffled Batcher and its worker pool into ``Trainer.step``: a warm
  epoch, a data-only epoch and a timed epoch (host clock, ending in a sync).
  ``data_fraction_of_step`` keeps 3 significant digits (the JAX tool rounds
  it to 3 decimals, which reads 0.0 for a ratio below 0.0005).
match: the matcher alone on random, DETR-shaped and degenerate costs at
  (batch, queries, targets): the CUDA auction (CUDA events) against scipy's
  exact LAP on the host; ``--plain_auction`` adds the plain PyTorch auction
  once per cost (seconds to minutes on the capped cases).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from countdetr_tpu_torch import config as cfglib
from countdetr_tpu_torch.models.anchor_detr import resolve_device

EXEMPLARS = [[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6], [0.2, 0.5, 0.4, 0.7]]


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sig3(x: float) -> float:
    """x to 3 significant digits: a positive ratio stays positive."""
    return float(f"{x:.3g}")


def _timed_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean milliseconds a call over ``iters`` calls: CUDA events on the
    card, the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _model_config(stage: int, dtype: str, queries=None) -> cfglib.ModelConfig:
    cfg = cfglib.stage2_config() if stage == 2 else cfglib.stage1_config()
    cfg = cfg.replace(compute_dtype=dtype)
    return cfg.replace(num_query_position=queries) if queries is not None else cfg


def _inputs(stage: int, size: int, batch: int, rng, points: int = 3):
    """Random normalized images, no padding, and stage 2's exemplar boxes or
    stage 1's exemplar centres as points."""
    images = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(np.float32))
    mask = torch.zeros((batch, size, size), dtype=torch.bool)
    if stage == 2:
        return images, mask, torch.tensor(EXEMPLARS, dtype=torch.float32).expand(batch, 3, 4)
    pts = torch.from_numpy(rng.uniform(0.1, 0.9, (batch, points, 2)).astype(np.float32))
    return images, mask, pts, torch.ones((batch, points), dtype=torch.bool)


class _BytesCounter(TorchDispatchMode):
    """The bytes of every operator's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.bytes += sum(t.numel() * t.element_size() for t in tree_leaves((args, kwargs, out))
                          if isinstance(t, torch.Tensor))
        return out


def flops_report(stage=2, size=592, dtype="float32"):
    """FLOPs and operator bytes of one forward at size x size, batch 1, on
    the plain path on the CPU (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from countdetr_tpu_torch.models.anchor_detr import build_model

    model = build_model(_model_config(stage, dtype), device="cpu", seed=0)
    inputs = _inputs(stage, size, 1, np.random.default_rng(0))
    counter, nbytes = FlopCounterMode(display=False), _BytesCounter()
    with torch.inference_mode(), counter, nbytes:
        model(*inputs)
    out = {"mode": "flops", "stage": stage, "image_size": size,
           "gflops_per_image": round(counter.get_total_flops() / 1e9, 2),
           "bytes_accessed_gb": round(nbytes.bytes / 1e9, 3),
           "counted_on": "cpu (plain path, FlopCounterMode)"}
    print(json.dumps(out))
    return out


def _train_batch(stage, size, batch, rng, max_boxes):
    images, mask, *prior = _inputs(stage, size, batch, rng)
    if stage == 2:
        T = max_boxes or 128
        boxes = rng.uniform(0.2, 0.7, (batch, T, 4)).astype(np.float32)
        boxes[..., 2:] = np.clip(boxes[..., 2:], 0.02, 0.2)
        return {"images": images, "pad_mask": mask, "exemplar_boxes": prior[0],
                "boxes": torch.from_numpy(boxes),
                "boxes_valid": torch.ones((batch, T), dtype=torch.bool),
                "batch_valid": torch.ones((batch,), dtype=torch.bool)}
    return {"images": images, "pad_mask": mask, "points": prior[0], "points_valid": prior[1],
            "whs": torch.from_numpy(rng.uniform(0.05, 0.3, (batch, 3, 2)).astype(np.float32))}


def train_throughput(stage=2, size=384, batch=8, dtype="bfloat16", iters=10, queries=None,
                     max_boxes=None, device="cuda"):
    """Training images a second: Trainer.step (forward, matching on the
    device, backward, AdamW) on one batch held on the device."""
    from countdetr_tpu_torch.train.train_step import Trainer

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    mcfg = _model_config(stage, dtype, queries)
    trainer = Trainer(mcfg, cfglib.TrainConfig(), device=dev, seed=0, steps_per_epoch=100)
    batch_d = {k: v.to(dev) for k, v in _train_batch(stage, size, batch, rng, max_boxes).items()}
    float(trainer.step(batch_d)["loss"])  # warm: the kernels' first launches, cuDNN plans
    step_ms = _timed_ms(lambda: trainer.step(batch_d), iters, dev)
    out = {"mode": "train", "stage": stage, "image_size": size, "batch": batch,
           "queries": mcfg.num_queries, "targets": (max_boxes or 128) if stage == 2 else 0,
           "img_per_s_per_chip": round(batch * 1e3 / step_ms, 2), "step_ms": step_ms,
           "device": _device_name(dev)}
    print(json.dumps(out))
    return out


def e2e_throughput(size=592, batch=8, dtype="bfloat16", num_workers=0, decoded_cache=False,
                   decoded_cache_dir="", n_images=64, data_root=None, device="cuda"):
    """Stage-2 training throughput with the data path in the loop, on a
    synthetic tree written under ``data_root`` (default: the temp
    directory): a warm epoch, a data-only epoch (no device work) and the
    timed epoch."""
    from countdetr_tpu_torch.data.batching import Batcher, prefetch
    from countdetr_tpu_torch.data.fscd147 import FSC147Pseudo
    from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
    from countdetr_tpu_torch.train.train_step import Trainer

    dev = resolve_device(device)
    root = data_root or os.path.join(tempfile.gettempdir(),
                                     f"countdetr_torch_bench_{size}_{n_images}")
    make_synthetic_fscd147(root, n_train=n_images, n_val=4, n_test=4, size=(size, size),
                           objects=(8, 48))
    cm = (f"disk:{decoded_cache_dir}" if decoded_cache_dir
          else "decoded" if decoded_cache else False)
    ds = FSC147Pseudo(root, "train", cache_mode=cm)
    ds.host_normalize = False  # the CLI's pipe: raw uint8, s2d-packed, normalized on the device
    b = Batcher(ds, batch, ((size, size),), max_boxes=64, shuffle=True,
                num_workers=num_workers, pack_s2d=True)
    trainer = Trainer(_model_config(2, dtype), cfglib.TrainConfig(), device=dev, seed=0,
                      steps_per_epoch=max(len(b), 1))

    def run_epoch(do_step: bool):
        n, last = 0, None
        t0 = time.perf_counter()
        for batch_d in prefetch(iter(b), depth=max(num_workers, 2)):
            n += int(batch_d["batch_valid"].sum())
            if do_step:
                last = trainer.step(batch_d)
        if last is not None:
            float(last["loss"])  # the device's queued steps end before the clock
        return n, time.perf_counter() - t0

    try:
        run_epoch(True)  # warm: the pool's start, the caches, the kernels' first launches
        n_data, dt_data = run_epoch(False)
        n_e2e, dt_e2e = run_epoch(True)
    finally:
        b.close()
    out = {"mode": "e2e", "stage": 2, "image_size": size, "batch": batch,
           "num_workers": num_workers,
           "decoded_cache": (decoded_cache_dir and "disk") or bool(decoded_cache),
           "img_per_s_e2e": round(n_e2e / dt_e2e, 2),
           "img_per_s_data_only": round(n_data / dt_data, 2),
           "data_fraction_of_step": sig3(dt_data / dt_e2e if dt_e2e > 0 else float("nan")),
           "device": _device_name(dev)}
    print(json.dumps(out))
    return out


def cost_structures(rng, B, Q, T):
    """Random, DETR-shaped (5 L1 + 2 class) and degenerate (near-identical
    rows: the worst contention) (B, Q, T) costs, as the JAX tool's."""
    pb, tb = rng.uniform(0.1, 0.9, (B, Q, 2)), rng.uniform(0.1, 0.9, (B, T, 2))
    l1 = np.abs(pb[:, :, None] - tb[:, None, :]).sum(-1)
    base = rng.normal(size=(B, 1, T)).astype(np.float32)
    return {"random": rng.normal(size=(B, Q, T)).astype(np.float32) * 5,
            "detr": (5 * l1 + 2 * rng.uniform(-1, 0, (B, Q, 1))).astype(np.float32),
            "degenerate": base + rng.normal(size=(B, Q, T)).astype(np.float32) * 1e-4}


def match_bench(batch=8, queries=576, targets=700, iters=3, plain=False, device="cuda"):
    """The matcher alone: ``cuda_{cost}_ms`` (the auction kernel, on
    ``device`` "cuda"), ``scipy_{cost}_ms`` (exact LAP on the host) and with
    ``plain`` ``plain_{cost}_ms`` (the plain auction on the CPU, one call)."""
    from countdetr_tpu_torch.ops import matching

    dev = resolve_device(device)
    B, Q, T = batch, queries, targets
    valid = torch.ones((B, T), dtype=torch.bool)
    results = {"mode": "match", "batch": B, "queries": Q, "targets": T,
               "device": _device_name(dev)}
    cpu = torch.device("cpu")
    for name, cost in cost_structures(np.random.default_rng(0), B, Q, T).items():
        c = torch.from_numpy(cost)
        if dev.type == "cuda":
            cd, vd = c.to(dev), valid.to(dev)
            matching.batched_match(cd, vd)  # warm: the kernel's first launch
            results[f"cuda_{name}_ms"] = _timed_ms(lambda: matching.batched_match(cd, vd),
                                                   iters, dev)
        results[f"scipy_{name}_ms"] = _timed_ms(lambda: matching.exact_batched_match(c, valid),
                                                iters, cpu)
        if plain:
            results[f"plain_{name}_ms"] = _timed_ms(lambda: matching.batched_match(c, valid),
                                                    1, cpu)
    print(json.dumps(results))
    return results


def get_args_parser():
    ap = argparse.ArgumentParser("Counting-DETR on CUDA: bench")
    ap.add_argument("--mode", default="flops", choices=["flops", "train", "e2e", "match"])
    ap.add_argument("--stage", default=2, type=int)
    ap.add_argument("--size", default=592, type=int)
    ap.add_argument("--batch", default=8, type=int)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", default=10, type=int)
    ap.add_argument("--queries", default=None, type=int,
                    help="num_query_position (stage-2 production: 600)")
    ap.add_argument("--max_boxes", default=None, type=int,
                    help="target capacity T for the matcher/loss shapes (stage-2 production: 700)")
    ap.add_argument("--num_workers", default=0, type=int)
    ap.add_argument("--decoded_cache", action="store_true")
    ap.add_argument("--decoded_cache_dir", default="", type=str)
    ap.add_argument("--n_images", default=64, type=int)
    ap.add_argument("--plain_auction", action="store_true",
                    help="--mode match: also time the plain PyTorch auction on the CPU, once")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; a missing card raises) or 'cpu' (the plain "
                    "versions; --mode match then times scipy and the plain auction only)")
    return ap


def main(a):
    if a.mode == "flops":
        return flops_report(a.stage, a.size, "float32")
    if a.mode == "match":
        q = a.queries or 600
        return match_bench(batch=a.batch, queries=int(q ** 0.5) ** 2,  # grid prior: 24x24
                           targets=a.max_boxes or 700, iters=a.iters, plain=a.plain_auction,
                           device=a.device)
    if a.mode == "e2e":
        return e2e_throughput(a.size, a.batch, a.dtype, num_workers=a.num_workers,
                              decoded_cache=a.decoded_cache,
                              decoded_cache_dir=a.decoded_cache_dir, n_images=a.n_images,
                              device=a.device)
    return train_throughput(a.stage, a.size, a.batch, a.dtype, iters=a.iters,
                            queries=a.queries, max_boxes=a.max_boxes, device=a.device)


if __name__ == "__main__":
    main(get_args_parser().parse_args())

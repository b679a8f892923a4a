"""The port's measuring tool on the CPU at a tiny size: each mode prints
one JSON line holding the JAX tool's keys (countdetr_tpu/cli/bench.py),
and the device it ran on.

- flops: within 1% of a hand count of the tiny model's convolutions and
  linear layers, 2 FLOPs a multiply-add from each call's shapes (what the
  count leaves out, the attention cores' products over 12x12 keys and 25
  queries at width 32, is under 0.1% of it);
- train (both stages), e2e (the synthetic tree, the Batcher and
  Trainer.step), match: the scipy route and the flag-guarded plain auction
  (the CUDA route needs the card, and is left out on the CPU);
- e2e's ``data_fraction_of_step`` keeps 3 significant digits, so a ratio
  far below 0.0005 (a loaded host: a 0.2 img/s step against a 441 img/s
  data path) still reads positive, where the JAX tool's 3 decimals read 0.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from countdetr_tpu_torch import config as cfglib
from countdetr_tpu_torch.cli import bench
from countdetr_tpu_torch.models.anchor_detr import build_model

TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64)
JAX_KEYS = {
    "flops": {"stage", "image_size", "gflops_per_image", "bytes_accessed_gb"},
    "train": {"mode", "stage", "image_size", "batch", "queries", "targets",
              "img_per_s_per_chip"},
    "e2e": {"mode", "stage", "image_size", "batch", "num_workers", "decoded_cache",
            "img_per_s_e2e", "img_per_s_data_only", "data_fraction_of_step"},
    "match": {"mode", "batch", "queries", "targets"},
}


@pytest.fixture(autouse=True)
def tiny_models(monkeypatch):
    s1, s2 = cfglib.stage1_config, cfglib.stage2_config
    monkeypatch.setattr(cfglib, "stage1_config", lambda **kw: s1(**{**TINY, **kw}))
    monkeypatch.setattr(cfglib, "stage2_config", lambda **kw: s2(**{**TINY, **kw}))


def run(capsys, *argv):
    capsys.readouterr()
    out = bench.main(bench.get_args_parser().parse_args(list(argv)))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    mode = argv[argv.index("--mode") + 1]
    assert JAX_KEYS[mode] <= set(line), JAX_KEYS[mode] - set(line)
    return line


class HandCount(TorchFunctionMode):
    """2 x (output elements) x (multiply-adds per output) of every conv2d
    and linear call."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.conv2d:
            w = args[1]
            self.flops += 2 * out.numel() * w[0].numel()
        elif func is F.linear:
            self.flops += 2 * out.numel() * args[1].shape[1]
        return out


@pytest.mark.parametrize("stage", [1, 2])
def test_flops_within_one_percent_of_a_hand_count(capsys, stage):
    size = 192
    line = run(capsys, "--mode", "flops", "--stage", str(stage), "--size", str(size))
    assert line["stage"] == stage and line["image_size"] == size
    model = build_model(bench._model_config(stage, "float32"), device="cpu", seed=0)
    hand = HandCount()
    with torch.inference_mode(), hand:
        model(*bench._inputs(stage, size, 1, np.random.default_rng(0)))
    assert hand.flops > 5e9  # ResNet-50-DC5 at 192 px
    assert abs(line["gflops_per_image"] * 1e9 - hand.flops) <= 0.01 * hand.flops
    assert line["bytes_accessed_gb"] > 0


@pytest.mark.parametrize("stage", [1, 2])
def test_train_mode(capsys, stage):
    queries = ["--queries", "25"] if stage == 2 else []
    line = run(capsys, "--mode", "train", "--stage", str(stage), "--size", "64", "--batch", "2",
               "--iters", "2", "--max_boxes", "8", "--dtype", "float32", "--device", "cpu",
               *queries)
    assert line["device"] == "cpu" and line["img_per_s_per_chip"] > 0
    assert line["queries"] == (25 if stage == 2 else 3)
    assert line["targets"] == (8 if stage == 2 else 0)


def test_e2e_mode(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    line = run(capsys, "--mode", "e2e", "--size", "64", "--batch", "2", "--n_images", "4",
               "--dtype", "float32", "--device", "cpu")
    assert line["device"] == "cpu" and line["stage"] == 2
    assert line["img_per_s_e2e"] > 0 and line["img_per_s_data_only"] > 0
    assert 0 < line["data_fraction_of_step"] < 1
    assert (tmp_path / "countdetr_torch_bench_64_4" / "synthetic_manifest.json").exists()


@pytest.mark.parametrize("x,want", [(0.2 / 441.4, 0.000453), (1.23456e-6, 1.23e-6),
                                    (0.008123, 0.00812), (0.5, 0.5), (0.99949, 0.999)])
def test_data_fraction_keeps_three_significant_digits(x, want):
    got = bench.sig3(x)
    assert got == want and 0 < got < 1
    assert round(1.23456e-6, 3) == 0.0  # what 3 decimals would print


def test_match_mode_scipy_and_plain_routes(capsys):
    line = run(capsys, "--mode", "match", "--batch", "2", "--queries", "16", "--max_boxes", "20",
               "--iters", "1", "--plain_auction", "--device", "cpu")
    assert (line["batch"], line["queries"], line["targets"]) == (2, 16, 20)
    timed = {k for k in line if k.endswith("_ms")}
    assert timed == {f"{route}_{cost}_ms" for route in ("scipy", "plain")
                     for cost in ("random", "detr", "degenerate")}
    assert all(line[k] > 0 for k in timed)

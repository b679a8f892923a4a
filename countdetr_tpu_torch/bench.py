"""Serving throughput: images a second for the stage-2 detector at the 600px
eval geometry (592x592 -> 37x37 DC5 features), the port's counterpart of the
JAX package's root ``bench.py``.

    python -m countdetr_tpu_torch.bench      # one card

Prints one JSON line last on stdout, the JAX bench's line with the device
the number was taken on: {"metric", "value", "unit", "vs_baseline",
"device"}; and before it, on stderr, one JSON line with both estimators,
the device's busy time and idle share, the kernels' launches a forward and
the card, torch and CUDA versions and TF32 switches.

Inputs (``bench_inputs``): the JAX bench's arrays, from the same numpy seed:
raw uint8 images space-to-depth packed on the host to (B, 296, 296, 12)
(``data/batching.py::pack_space_to_depth``), normalised on the device; or,
with BENCH_PACKED=0, float32 normal (B, 592, 592, 3) images that go to the
unpacked stem as they are. No padding; the three exemplar boxes of every
image the same. The model is ``stage2_config`` (ResNet-50-DC5, hidden 256,
8 heads, 6+6 layers, 576 grid queries) with random weights from seed 0, in
eval mode under ``torch.inference_mode``: its RCDA and MHA cores launch
``csrc/rcda.cu`` (12 a forward) and ``csrc/mha.cu`` (6) on the card.

Timing, two estimators of one quantity, after one warm run of ``lo`` and one
of ``hi`` forwards:

1. PROFILER (BENCH_PROFILE=1, the default, and the reported value):
   ``torch.profiler`` with CPU and CUDA activities around one synchronised
   ``record_function("bench_loop")`` range of ``hi`` forwards; the value is
   B * hi / ``utils/xprof.py::device_envelope_seconds`` of the range: the
   span from its first to its last kernel, the gaps between kernels
   included. In the JAX bench that envelope is a jitted ``fori_loop``'s,
   with no host in it; here the gaps are the host's dispatch, so the
   envelope sits near the wall clock. A failure or a zero envelope exits
   non-zero: there is no fallback to the wall clock.
2. TWO-POINT WALL CLOCK (BENCH_PROFILE=0 reports it): the host clock around
   ``n`` forwards ending in ``torch.cuda.synchronize()``; rate =
   B * (hi - lo) / (t_hi - t_lo), lo = max(1, hi // 4), the best of
   BENCH_PAIRS pairs. Where every pair reads t_hi <= t_lo, the JAX bench's
   single-point rate B * hi / t_hi stands in, and the stderr line says
   ``"estimator": "single_point"``.

The stderr line also has the busy-time rate (B * hi over the kernels' own
durations in the range, ``range_seconds``), the idle share (1 - busy /
envelope), the profiler's device-side span of the range
(``gpu_user_annotation``, a cross-check of the envelope) and the profiled
range's wall clock, which against the unprofiled wall rate shows what the
profiler's per-op recording costs.

Per chip: the forward runs on one card, so the value is divided by 1 (the
JAX bench divides by ``jax.device_count()`` though its forward runs on one
device).

vs_baseline is against 19 images a second, AnchorDETR-DC5's published
inference speed on a V100 (arXiv 2109.07107, Table 1), the JAX bench's
baseline.

Environment knobs, the JAX bench's with its defaults: BENCH_BATCH (32),
BENCH_ITERS (the hi point, 40), BENCH_PAIRS (3), BENCH_DTYPE (bfloat16 |
float32), BENCH_PACKED (1 | 0), BENCH_PROFILE (1 | 0), BENCH_PALLAS (1
only: the JAX bench's 0 selects einsum cores with no kernel, and the port
has no such card path; its plain versions are the kernels' oracles); and
BENCH_DEVICE (cuda, the default: a missing card raises; cpu runs the plain
versions, for tests, and refuses BENCH_PROFILE=1).
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from countdetr_tpu_torch.config import ModelConfig, stage2_config
from countdetr_tpu_torch.data.batching import pack_space_to_depth
from countdetr_tpu_torch.models.anchor_detr import build_model, resolve_device
from countdetr_tpu_torch.utils.trace import launch_counts, reset_launches

METRIC = "images/sec/chip at 600px eval (stage-2 forward)"
UNIT = "img/s/chip"
REFERENCE_GPU_IMG_PER_S = 19.0
EXEMPLARS = [[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6], [0.2, 0.5, 0.4, 0.7]]
RANGE = "bench_loop"
DEFAULTS = {"BENCH_BATCH": "32", "BENCH_ITERS": "40", "BENCH_PAIRS": "3",
            "BENCH_DTYPE": "bfloat16", "BENCH_PACKED": "1", "BENCH_PROFILE": "1",
            "BENCH_PALLAS": "1", "BENCH_DEVICE": "cuda"}


def bench_inputs(batch: int, size: int = 592, packed: bool = True, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(images, pad_mask, exemplar_boxes) as numpy: packed uint8 (B, size/2,
    size/2, 12) or float32 normal (B, size, size, 3), an all-False (B, size,
    size) mask, the three exemplar boxes tiled to (B, 3, 4)."""
    rng = np.random.default_rng(seed)
    if packed:
        images = pack_space_to_depth(
            rng.integers(0, 256, (batch, size, size, 3)).astype(np.uint8))
    else:
        images = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    pad_mask = np.zeros((batch, size, size), dtype=bool)
    rects = np.tile(np.asarray(EXEMPLARS, np.float32)[None], (batch, 1, 1))
    return images, pad_mask, rects


def forwards(model, inputs, n: int, dev: torch.device):
    """``n`` forwards under inference_mode, waiting for the device; the last
    output."""
    out = None
    with torch.inference_mode():
        for _ in range(n):
            out = model(*inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _flag(env: Mapping[str, str], key: str) -> bool:
    value = env.get(key, DEFAULTS[key])
    if value not in ("0", "1"):
        raise SystemExit(f"bench: {key}={value!r}: 0 or 1")
    return value == "1"


def read_knobs(env: Mapping[str, str]) -> dict:
    """The BENCH_* knobs, checked; the refusals raise SystemExit (or, for a
    missing card, RuntimeError) before anything is built."""
    if env.get("BENCH_PALLAS", "1") != "1":
        raise SystemExit(
            "bench: BENCH_PALLAS=0 selects the JAX bench's einsum attention cores with no "
            "kernel; the port has no such card path (its plain versions are the kernels' "
            "oracles), so only BENCH_PALLAS=1 runs")
    dev = resolve_device(env.get("BENCH_DEVICE", DEFAULTS["BENCH_DEVICE"]))
    profile = _flag(env, "BENCH_PROFILE")
    if profile and dev.type != "cuda":
        raise SystemExit(f"bench: BENCH_PROFILE=1 reads the device's timeline; on "
                         f"{dev.type} pass BENCH_PROFILE=0")
    dtype = env.get("BENCH_DTYPE", DEFAULTS["BENCH_DTYPE"])
    if dtype not in ("bfloat16", "float32"):
        raise SystemExit(f"bench: BENCH_DTYPE={dtype!r}: bfloat16 or float32")
    knobs = {"device": dev, "profile": profile, "dtype": dtype,
             "packed": _flag(env, "BENCH_PACKED")}
    for key, name in (("BENCH_BATCH", "batch"), ("BENCH_ITERS", "hi"), ("BENCH_PAIRS", "pairs")):
        knobs[name] = int(env.get(key, DEFAULTS[key]))
        if knobs[name] < 1:
            raise SystemExit(f"bench: {key} must be at least 1")
    knobs["lo"] = max(1, knobs["hi"] // 4)
    return knobs


def profiled_loop(model, inputs, n: int, dev: torch.device) -> dict:
    """``n`` forwards in one synchronised ``bench_loop`` range under
    torch.profiler: the range's device envelope, busy time and device-side
    annotation span, and its wall clock (seconds); on the CPU, with no
    device events, the three device numbers are 0.0. The events are read
    back from the Chrome trace, which the profiler writes in C++ (building
    them in Python, ``events_from_profiler``, took ~30 s for 40 full-size
    forwards on an H100's host)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from countdetr_tpu_torch.utils import xprof

    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with record_function(RANGE):
            forwards(model, inputs, n, dev)  # ends in a synchronize
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = xprof.load_trace(path)
    return {"envelope_s": xprof.device_envelope_seconds(events, RANGE),
            "busy_s": xprof.range_seconds(events, RANGE),
            "annotation_s": xprof.annotation_seconds(events, RANGE),
            "wall_s": wall, "parse_s": time.perf_counter() - t1}


def main(env: Mapping[str, str] = os.environ, model_cfg: Optional[ModelConfig] = None,
         size: int = 592) -> int:
    """Run the bench with ``env``'s knobs on ``model_cfg`` (default the full
    stage-2 model) at ``size`` x ``size``; print the stderr line and the
    result line; 0 on success."""
    k = read_knobs(env)
    dev, B, hi, lo = k["device"], k["batch"], k["hi"], k["lo"]
    cfg = (model_cfg or stage2_config()).replace(compute_dtype=k["dtype"])
    model = build_model(cfg, device=dev, seed=0)
    inputs = tuple(torch.from_numpy(a).to(dev)
                   for a in bench_inputs(B, size, packed=k["packed"]))

    def timed(n):
        t0 = time.perf_counter()
        forwards(model, inputs, n, dev)
        return time.perf_counter() - t0

    out = forwards(model, inputs, 1, dev)  # first launches, cuDNN plans
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        if not bool(torch.isfinite(out[key]).all()):
            raise SystemExit(f"bench: non-finite {key}")
    timed(lo)
    timed(hi)
    reset_launches()
    n_forwards = 0

    # estimator 1: the device envelope of a profiled range
    prof = None
    if k["profile"]:
        prof = profiled_loop(model, inputs, hi, dev)
        n_forwards += hi
        if not prof["envelope_s"] > 0:
            raise SystemExit(f"bench: the profiler's bench_loop range holds no device event "
                             f"({prof}); no rate")

    # estimator 2: two-point wall clock
    rates, t_hi = [], None
    for _ in range(k["pairs"]):
        t_lo = timed(lo)
        t_hi = timed(hi)
        n_forwards += lo + hi
        if t_hi > t_lo:
            rates.append(B * (hi - lo) / (t_hi - t_lo))
    wall_estimator = "two_point" if rates else "single_point"
    rate_wall = max(rates) if rates else B * hi / t_hi
    launches = launch_counts()

    stats = {"estimator": "device_profile" if prof else wall_estimator,
             "wall_estimator": wall_estimator,
             "device_profile_img_per_s": B * hi / prof["envelope_s"] if prof else None,
             "wall_img_per_s": rate_wall, "wall_pair_rates": rates,
             "busy_img_per_s": B * hi / prof["busy_s"] if prof and prof["busy_s"] > 0 else None,
             "device_idle_share": 1.0 - prof["busy_s"] / prof["envelope_s"] if prof else None,
             "envelope_ms_per_forward": prof["envelope_s"] * 1e3 / hi if prof else None,
             "gpu_user_annotation_ms_per_forward":
                 prof["annotation_s"] * 1e3 / hi if prof else None,
             "profiled_wall_img_per_s": B * hi / prof["wall_s"] if prof else None,
             "profile_parse_s": prof["parse_s"] if prof else None,
             "batch": B, "size": size, "dtype": k["dtype"], "packed": k["packed"],
             "hi": hi, "lo": lo, "pairs": k["pairs"], "forwards": n_forwards,
             "launches": launches,
             "launches_per_forward": {name: n / n_forwards for name, n in launches.items()},
             "device": _device_name(dev), "torch": torch.__version__,
             "cuda": torch.version.cuda,
             "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn": torch.backends.cudnn.allow_tf32}}
    print(json.dumps(stats), file=sys.stderr, flush=True)

    # per chip: the forward runs on one card
    rate = stats["device_profile_img_per_s"] if prof else rate_wall
    if not (math.isfinite(rate) and rate > 0):
        raise SystemExit(f"bench: rate {rate}")
    value = round(rate, 2)
    print(json.dumps({"metric": METRIC, "value": value, "unit": UNIT,
                      "vs_baseline": round(value / REFERENCE_GPU_IMG_PER_S, 2),
                      "device": _device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

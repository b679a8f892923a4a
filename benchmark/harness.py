"""The benchmark of ``countdetr_tpu_torch`` on NVIDIA H100s: one run of one
cell of ``BENCHMARK.json``, driven by the files it names.

    python3 benchmark/run.py --workload s2_serve_b32 --seed 7 --seconds 20 --trace 0

A cell (an entry of the manifest's ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the model's sizes, the precision, how
the weights are drawn) and a traffic mix (``benchmark/traffic/<traffic>.json``:
the parameters that the generator module ``benchmark/generators/<generator>.py``
reads); the cell's own file ``benchmark/workloads/<name>.json`` names the
entry driver (``benchmark/drivers/<driver>.py``), its parameters, and the
output check's sample and limits. Every metric is a reader of its own,
``benchmark/metrics/<metric>.py`` (``read(ctx)`` -> a number or None). A
cell, a configuration, a mix or a metric is added with new files and new
manifest entries; nothing here names one.

A run: check the card; draw the weights and the traffic from ``--seed``;
set up the driver (the program's entry object, every shape warmed);
measure the window for ``--seconds``; with ``--trace 1`` run the profiled
sub-window after it; read the peak memory; free the program; check its
outputs against the plain reference (``benchmark/reference``); check that
no JAX module was loaded; print the compared numbers beside their limits
on stderr and one JSON line last on stdout.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# whole top-level module names the run's process may not hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "countdetr_tpu")


@dataclasses.dataclass
class Window:
    """What the measured window did: seconds on the host clock, requests
    attempted and failed, each completed request's latency, the completed
    images as (h, w, points), and the points labelled."""
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    images: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    points: int = 0


@dataclasses.dataclass
class Trace:
    """The profiled sub-window: the trace's complete events, the name of
    its one range, the real images its forwards ran ((h, w, points)) and
    its requests."""
    events: List[dict]
    range: str
    images: List[Tuple[int, int, int]]
    requests: int


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    model: dict
    dtype: str
    setup_s: float
    window: Window
    trace: Optional[Trace] = None


@dataclasses.dataclass
class Check:
    """One compared number, its limit, and whether it is held (value <=
    limit)."""
    name: str
    value: float
    limit: float

    @property
    def held(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def module(kind: str, name: str, root: Path = ROOT):
    """benchmark/<kind>/<name>.py, imported as a package module (so that
    spawned workers can unpickle what it defines)."""
    if root == ROOT:
        return importlib.import_module(f"benchmark.{kind}.{name}")
    return _load_path(root / "benchmark" / kind / f"{name}.py", f"bench_{kind}_{name}")


def _load_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` of benchmark/metrics/<name>.py."""
    return _load_path(root / "benchmark" / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_")).read


def cell_metrics(man: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metric entries of the manifest that ``cell``
    reports: those that list it, or list no cells; a per-layer metric that
    lists none goes with every cell that reports the metric it moves."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def seed_of(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy and torch."""
    return int(seed) % (2**63)


def forbidden_loaded(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def set_precision(precision: dict):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(precision["matmul_allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn_allow_tf32"])


def profile_range(run: Callable[[], Tuple[List[Tuple[int, int, int]], int]], device,
                  range_name: str = "bench_window") -> Trace:
    """``run()`` inside one ``record_function`` range under torch.profiler
    (CPU and, on a card, CUDA activities), the device waited for as the
    range opens and closes; the events read back from the Chrome trace,
    which the profiler writes in C++ (under TMPDIR, removed after)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.yardstick import xprof

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(range_name):
            images, requests = run()
            if on_card:
                torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="countdetr_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = xprof.load_trace(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events=events, range=range_name, images=images, requests=requests)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", root: Path = ROOT, overrides: Optional[dict] = None,
             log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object. ``overrides``
    (tests) replaces groups of the configuration, mix or cell file:
    {"model": {...}, "traffic": {...}, "cell": {...}}, each merged key by
    key."""
    import torch

    overrides = overrides or {}
    man = manifest(root)
    entry = find_cell(man, workload)
    cfg = load_json(root / "benchmark" / "configs" / f"{entry['config']}.json")
    mix = load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    cell = load_json(root / "benchmark" / "workloads" / f"{workload}.json")
    cfg["model"] = {**cfg["model"], **overrides.get("model", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    cell = {**cell, **overrides.get("cell", {})}
    e2e, layer = cell_metrics(man, workload)

    on_card = torch.device(device).type == "cuda"
    set_precision(cfg["precision"])
    s = seed_of(seed)
    generator = module("generators", mix["generator"], root)
    driver_mod = module("drivers", cell["driver"], root)
    traffic = generator.generate(mix, s, device)
    driver = driver_mod.Driver(cfg, mix, cell, traffic, s, device)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    window = driver.window(seconds)
    prof = profile_range(driver.profiled, device) if trace else None
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks: List[Check] = driver.compare()

    ctx = Context(model=cfg["model"], dtype=cfg["precision"]["compute_dtype"],
                  setup_s=setup_s, window=window, trace=prof)
    metrics = {}
    for m in (layer if trace else e2e):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(checks) and all(c.held for c in checks)
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": entry["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": info}
    if prof is not None:
        from benchmark.yardstick import readers

        busy = readers.busy_seconds(ctx)
        spans = [e for e in prof.events
                 if e.get("cat") == "user_annotation" and e["name"] == prof.range]
        info["busy_s"] = busy
        info["window_s"] = sum(float(e["dur"]) for e in spans) / 1e6
        result["breakdown"] = readers.breakdown(ctx)
    # a number that could not be read (no output to compare) prints as null
    result["check"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                                "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'held' if c.held else 'FAILED'}", file=log)
    print(f"correct {correct}", file=log, flush=True)
    return result


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    entry = find_cell(manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: the cell needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the run's process loaded {found}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0

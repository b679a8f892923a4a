"""Device time of the stage-2 eval forward by category and by kernel, at the
serving bench's geometry (``countdetr_tpu_torch/bench.py``): the port's
counterpart of the JAX package's ``scripts/profile_eval.py``.

    python -m countdetr_tpu_torch.cli.profile_eval [--iters 10] [--batch 32] \\
        [--dtype bfloat16] [--packed 1] [--trace_dir DIR] [--parse_only] [--device cuda]

Capture (on the card): the bench's inputs and model, one warm forward
outside the trace, then ``iters`` forwards inside one synchronised
``record_function("bench_loop")`` range under ``torch.profiler`` (CPU and
CUDA activities), written as a Chrome trace into ``--trace_dir``.

Parse (``--parse_only`` parses an existing trace): ``utils/xprof.py`` sums
the kernels, copies and memsets by name and category (``name_category``:
the port's RCDA, MHA and auction kernels are "custom-call", cuDNN
"convolution", cuBLAS and CUTLASS "dot", PyTorch's elementwise kernels
"elementwise", ...). The range's device envelope (first to last kernel in
it, gaps included) over ``iters`` gives ms a forward and img/s; the
profiler's own device-side span of the range ("gpu_user_annotation") is
printed beside it. Neither is a device op, so the total and the table hold
only kernels, copies and memsets. Prints the total, the table by category
with shares and the top 25 kernels, and writes the JAX script's summary
JSON (``total_s``, ``while_envelope_s`` holding the range's envelope,
``iters``, ``batch``, ``packed``, ``by_category``, ``top_ops``) to
``--summary``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from countdetr_tpu_torch import bench
from countdetr_tpu_torch.config import stage2_config
from countdetr_tpu_torch.models.anchor_detr import build_model, resolve_device
from countdetr_tpu_torch.utils import xprof

TRACE_NAME = "profile_eval_trace.json"


def capture(trace_dir: str, batch: int, iters: int, dtype: str, packed: bool,
            device: str = "cuda", model_cfg=None, size: int = 592) -> str:
    """Profile ``iters`` forwards after a warm one; the Chrome trace's path."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    cfg = (model_cfg or stage2_config()).replace(compute_dtype=dtype)
    model = build_model(cfg, device=dev, seed=0)
    inputs = tuple(torch.from_numpy(a).to(dev)
                   for a in bench.bench_inputs(batch, size, packed=packed))
    bench.forwards(model, inputs, 1, dev)  # first launches, cuDNN plans: outside the trace
    with profile(activities=activities) as prof:
        with record_function(bench.RANGE):
            bench.forwards(model, inputs, iters, dev)  # ends in a synchronize
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    return path


def summarize(events, iters: int, batch: int, packed: bool, top: int = 25) -> dict:
    """The JAX script's summary of a trace's events: device op time in all,
    by category and by name (the ``top`` largest), and the bench_loop
    range's envelope."""
    per_op, total = xprof.op_table(events)
    by_cat = {}
    for dur, _cnt, cat in per_op.values():
        c = cat or "uncategorized"
        by_cat[c] = by_cat.get(c, 0.0) + dur
    rows = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "total_s": total,
        "while_envelope_s": xprof.device_envelope_seconds(events, bench.RANGE),
        "iters": iters,
        "batch": batch,
        "packed": packed,
        "by_category": by_cat,
        "top_ops": [{"name": n, "s": d, "count": c, "category": cat}
                    for n, (d, c, cat) in rows],
    }


def report(summary: dict, annotation_s: float):
    env, iters, B = summary["while_envelope_s"], summary["iters"], summary["batch"]
    total = summary["total_s"]
    share = (lambda d: 100 * d / total) if total > 0 else (lambda d: 0.0)
    if env > 0:
        per_fwd = env / iters
        print(f"\nbench_loop envelope: {env * 1e3:.2f} ms / {iters} iters"
              f" = {per_fwd * 1e3:.2f} ms/forward @ B={B}"
              f" -> {B / per_fwd:.1f} img/s device-side"
              f" (gpu_user_annotation span {annotation_s * 1e3:.2f} ms)")
    print(f"total device op time: {total * 1e3:.2f} ms")
    print("\n== by category ==")
    for c, d in sorted(summary["by_category"].items(), key=lambda kv: -kv[1]):
        print(f"  {c:30s} {d * 1e3:9.2f} ms  {share(d):5.1f}%")
    print(f"\n== top {len(summary['top_ops'])} ops ==")
    for op in summary["top_ops"]:
        print(f"  {op['s'] * 1e3:8.2f} ms {share(op['s']):5.1f}% x{op['count']:<5d}"
              f" [{(op['category'] or '?'):12s}] {op['name'][:90]}")


def get_args_parser():
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser("Counting-DETR on CUDA: device time of the eval forward")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--packed", type=int, default=1,
                    help="1: the uint8 s2d-packed input pipe; 0: float32 (B,H,W,3)")
    ap.add_argument("--trace_dir", default=os.path.join(tmp, "profile_eval_torch"))
    ap.add_argument("--parse_only", action="store_true",
                    help="parse the newest trace under --trace_dir; capture nothing")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; a missing card raises) or 'cpu' (no device "
                    "ops: an empty table)")
    ap.add_argument("--summary", default=os.path.join(tmp, "profile_eval_torch_summary.json"),
                    help="where the summary JSON goes")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    if not args.parse_only:
        capture(args.trace_dir, args.batch, args.iters, args.dtype, bool(args.packed),
                args.device)
    events = xprof.load_trace(args.trace_dir)
    summary = summarize(events, args.iters, args.batch, bool(args.packed))
    report(summary, xprof.annotation_seconds(events, bench.RANGE))
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"\nwrote {args.summary}")
    return summary


if __name__ == "__main__":
    main()

"""Readings that a cell's limits are set from where ``limits.py``'s control
(the program's bfloat16 path) cannot run the cell: the bfloat16 RCDA
kernel takes no grid past 64 x 64, so on ``detr_coco_b8``'s 50 x 84 grids
every call of that control fails before a number is read.

    python3 benchmark/limits_precision.py --workload detr_coco_b8 --mode tf32 --seeds 6

Modes, each a whole run of the cell a seed, in one process:
  sound  the configuration as it states its precision;
  tf32   the configuration with TF32 in the matmuls too (torch's
         ``matmul.allow_tf32``): the nearest precision below it;
  bf16   the program's bfloat16 path, its RCDA through the plain core
         (``rcda_kernel.PLAIN``) where the bfloat16 kernel cannot go.
Prints one JSON line a run: the mode, the seed, each compared number and
``correct``. PERF.md gives each limit beside its sound and control
readings.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("sound", "tf32", "bf16")


@contextlib.contextmanager
def precision(mode: str):
    """The harness and the program patched for ``mode``; undone on exit."""
    import torch

    from benchmark import harness
    from countdetr_tpu_torch.ops.kernels import rcda_kernel

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    set_precision, forward = harness.set_precision, rcda_kernel._rcda_forward

    def plain_bf16(q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads, variant="v3"):
        args = (q_row, q_col, k_row, k_col, v, bias_row, bias_col, num_heads)
        if q_row.dtype == torch.bfloat16:
            return rcda_kernel.PLAIN[variant](*args)
        return forward(*args, variant)

    try:
        if mode == "tf32":
            harness.set_precision = lambda p: set_precision({**p, "matmul_allow_tf32": True})
        if mode == "bf16":
            rcda_kernel._rcda_forward = plain_bf16
        yield
    finally:
        harness.set_precision, rcda_kernel._rcda_forward = set_precision, forward


def readings(workload: str, mode: str, seeds, seconds: float, device: str = "cuda",
             overrides=None):
    """Yield (seed, result) for each seed: a whole run of the cell in
    ``mode``; ``overrides`` (tests) as ``harness.run_cell`` takes them."""
    from benchmark import harness

    over = dict(overrides or {})
    if mode == "bf16":
        over["model"] = {**over.get("model", {}), "compute_dtype": "bfloat16"}
    with precision(mode):
        for seed in seeds:
            with open(os.devnull, "w") as quiet:
                yield seed, harness.run_cell(workload, seed, seconds, False, time.perf_counter(),
                                             device=device, overrides=over, log=quiet)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first_seed", type=int, default=4_300_000_000)
    args = p.parse_args()
    seeds = range(args.first_seed, args.first_seed + args.seeds)
    for seed, res in readings(args.workload, args.mode, seeds, args.seconds):
        print(json.dumps({"cell": args.workload, "seed": seed, "mode": args.mode,
                          "check": {k: v["value"] for k, v in res["check"].items()},
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"]}), flush=True)


if __name__ == "__main__":
    main()

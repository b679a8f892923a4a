"""Readings that the output check's limits are set from: the program on
many seeds, and the control (the program's own bfloat16 path, the
precision below the configuration's float32), in one process so that the
set-up's imports and kernel builds are paid once.

    python3 benchmark/limits.py --workload s2_serve_b32 --seeds 12 --control 3 --seconds 3

Prints one JSON line a run: the cell, the seed, whether it was the
control, each compared number and ``correct``. Each limit lies above the
largest sound reading and below the smallest control reading (PERF.md
gives both readings beside each limit).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL = {"model": {"compute_dtype": "bfloat16"}}


def readings(workload: str, seeds, control: bool, seconds: float, device: str = "cuda",
             overrides=None):
    """Yield (seed, result) for each seed: a whole run of the cell, the
    control's when ``control``."""
    from benchmark import harness

    over = dict(overrides or {})
    if control:
        over["model"] = {**over.get("model", {}), **CONTROL["model"]}
    for seed in seeds:
        with open(os.devnull, "w") as quiet:
            yield seed, harness.run_cell(workload, seed, seconds, False, time.perf_counter(),
                                         device=device, overrides=over, log=quiet)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first_seed", type=int, default=4_100_000_000)
    args = p.parse_args()
    base = args.first_seed
    for control, n in ((False, args.seeds), (True, args.control)):
        seeds = range(base, base + n)
        base += n
        for seed, res in readings(args.workload, seeds, control, args.seconds):
            print(json.dumps({"cell": args.workload, "seed": seed, "control": control,
                              "check": {k: v["value"] for k, v in res["check"].items()},
                              "correct": res["correct"], "attempted": res["attempted"],
                              "failed": res["failed"]}), flush=True)


if __name__ == "__main__":
    main()

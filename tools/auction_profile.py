#!/usr/bin/env python3
"""Where an auction round's time goes on the card, by phase.

    python3 tools/auction_profile.py [--clusters 8 16]   # one CUDA card

Builds an instrumented copy of ``countdetr_tpu_torch/csrc/auction.cu``
(clock64 probes in thread 0 of every block of image 0, nothing else
changed) into ``countdetr_tpu_torch/_build/``, runs the matcher's 8x576x700
DETR-shaped batch (chip_smoke.py's, image 0 with 40 valid targets, which
runs to the 13248-round cap) on each cluster size, checks the assignment,
rounds and bids against the plain version, and prints one JSON line per
size: kernel_ms (CUDA events), microseconds a round, and per block the
microseconds a round in each phase (bid: the block's rows scanned and their
keys posted; sync1: the cluster barrier after the bids; award; sync2: the
barrier after the award) and the cycles a bidding row of half-warp 0 spends
in its scan, its butterfly and its tail. Cycles convert to microseconds at
nvidia-smi's maximum SM clock. The probes cost a few percent of the round.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBES = [  # (anchor in auction.cu, text put in its place)
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ long long g_prof[16 * 8];\n\nnamespace {\n\nconstexpr int kThreads"),
    ("  long long my_bids = 0;",
     "  long long pf[8] = {}, t0 = 0, t1 = 0, r0 = 0, r1 = 0, r2 = 0;\n  long long my_bids = 0;"),
    ("    ++seq;\n    bool bid_any = false;", "    ++seq;\n    t0 = clock64();\n    bool bid_any = false;"),
    ("      float v1 = -INFINITY, v2 = -INFINITY;",
     "      r0 = clock64();\n      float v1 = -INFINITY, v2 = -INFINITY;"),
    ("      for (int off = kRowLanes / 2; off > 0; off >>= 1) {",
     "      r1 = clock64(); pf[4] += r1 - r0;\n"
     "      for (int off = kRowLanes / 2; off > 0; off >>= 1) {"),
    ("      if (rl == 0) {\n", "      r2 = clock64(); pf[5] += r2 - r1;\n      if (rl == 0) {\n"),
    ("        ++my_bids;\n      }\n", "        ++my_bids;\n      }\n      pf[6] += clock64() - r2;\n      ++pf[7];\n"),
    ("    // slot `rank` of every CTA", "    t1 = clock64(); pf[0] += t1 - t0;\n    // slot `rank` of every CTA"),
    ("    cluster.sync();\n    bool any = false;",
     "    cluster.sync();\n    t0 = clock64(); pf[1] += t0 - t1;\n    bool any = false;"),
    ("    cluster.sync();\n    ++it;",
     "    t1 = clock64(); pf[2] += t1 - t0;\n    cluster.sync();\n    pf[3] += clock64() - t1;\n    ++it;"),
    ("  if (rank == 0 && tid == 0) rounds_out[b] = it;",
     "  if (rank == 0 && tid == 0) rounds_out[b] = it;\n"
     "  if (b == 0 && tid == 0) for (int k = 0; k < 8; ++k) g_prof[rank * 8 + k] = pf[k];"),
]


def build(build_dir):
    from countdetr_tpu_torch.ops.kernels import _build

    src = open(os.path.join(_build.CSRC_DIR, "auction.cu")).read()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"auction.cu changed: probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    src += ('\nextern "C" int auction_profile(long long* out) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));\n}\n")
    os.makedirs(build_dir, exist_ok=True)
    cu, so = os.path.join(build_dir, "auction_profile.cu"), os.path.join(build_dir, "libauction_profile.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.auction_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.auction_profile.argtypes = [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", type=int, nargs="+", default=[8, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("auction_profile: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.ops.kernels import _build
    from countdetr_tpu_torch.ops.kernels import auction_kernel as ak

    lib = build(str(_build.BUILD_DIR))
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    dev = torch.device("cuda")
    cost = chip_smoke.cost_structures(np.random.default_rng(1), 8, 576, 700)["detr"]
    valid = np.ones((8, 700), bool)
    valid[0, 40:] = False
    benefit, active, eps, cap, _ = matching.auction_inputs(
        torch.from_numpy(cost).to(dev), torch.from_numpy(valid).to(dev))
    want = ak.auction_plain(benefit, active, eps, cap, with_stats=True)
    B, P, O = benefit.shape
    active_u8 = active.to(torch.uint8).contiguous()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for c in args.clusters:
        C, resident, _ = ak.cluster_plan(B, P, O, c)
        out = torch.empty((B, P), dtype=torch.int32, device=dev)
        rounds = torch.zeros(B, dtype=torch.int32, device=dev)
        bids = torch.zeros(B, dtype=torch.int64, device=dev)

        def call():
            bids.zero_()
            err = lib.auction_forward(
                benefit.data_ptr(), active_u8.data_ptr(), eps.data_ptr(), out.data_ptr(),
                rounds.data_ptr(), bids.data_ptr(), B, P, O, cap, 0, C, int(resident),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"auction_profile: launch failed, CUDA error {err}")

        call()
        torch.cuda.synchronize()
        identical = (torch.equal(out.long(), want[0]) and torch.equal(rounds.long(), want[1])
                     and torch.equal(bids, want[2]))
        ms = chip_smoke.cuda_ms(call, 3)
        prof = (ctypes.c_longlong * 128)()
        lib.auction_profile(prof)
        R = int(rounds.max())
        blocks = []
        for r in range(C):
            p = prof[8 * r:8 * r + 8]
            n = max(1, p[7])
            blocks.append({
                "us_per_round": dict(zip(("bid", "sync1", "award", "sync2"),
                                         (p[k] / R / mhz for k in range(4)))),
                "cycles_per_row": dict(zip(("scan", "butterfly", "tail"),
                                           (p[k] / n for k in (4, 5, 6)))),
                "rows_per_round": p[7] / R})
        print(json.dumps({"cluster": C, "resident": resident, "identical": bool(identical),
                          "kernel_ms": ms, "rounds": R, "us_per_round": ms * 1e3 / R,
                          "max_sm_mhz": mhz, "blocks": blocks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (countdetr_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as one JSON line:
  device    the card (nvidia-smi name and power limit), its SM count and
            maximum SM clock (the exponential rate of the bound), the kernel
            build, one nvcc per CUDA source (rcda, rcda_rank1, mha, auction,
            pack),
            all started together, each kernel's registers, spills and
            static shared memory and the compiler's warnings from ptxas (the
            build logs), the RCDA kernels' dynamic shared memory, and the
            auction's cluster plan on the matcher's shapes (blocks a
            cluster, rows resident or streamed, dynamic shared memory a
            block, clusters the card holds at once);
  kernels   each hand-written kernel against its plain PyTorch version at
            the main paths' shapes: RCDA and MHA in bfloat16 and float32 at
            B=32 (serving) and in bfloat16 at B=8 (the train step); RCDA v3
            and rank-1 in bfloat16 and float32 at the stage-1 shapes (B=8,
            24x42, L=1008 encoder with a padded image and L=700 decoder) and
            at B=32 37x37 (L=1369, 576); RCDA v3 bfloat16 at B=32 over the
            learned prior's L=900 decoder queries; MHA in bfloat16 at
            S=900 (B=32 and 8) and at B=8 over the pseudo-label point tiers
            S=700 and S=5600, one row fully masked; MHA in float32 at B=8
            S=700 and 576 (the decoder's self-attention in the CLI's default
            dtype); max error and its tolerance; each case names the
            source that ran: a float32 call of either variant runs rcda.cu
            (3xTF32 on the tensor cores where H, W <= 64 and d <= 32, so
            every case here), a bfloat16 rank-1 call rcda_rank1.cu; each
            float32 case gives its bound at the CUDA cores' 67 TFLOP/s too
            (cuda_core_bound_ms); the float32 kernels at the ddp phase's
            shapes, and rank-1 at stage 1's (B=16, 24x42, L=1008), repeated
            (bit-equal) and on each half of the batch (bit-equal to its
            rows);
            the auction with tolerance 0 (assignments, rounds and bids
            identical) on the matcher's shapes: 8x576x700 transposed on
            random, DETR-shaped and degenerate costs (the DETR-shaped one
            also on clusters of 4, 8 and 16, each timed), 16x576x700 with a
            sparse image in each half (more clusters than the card holds at
            once), 576x128 (targets bid), 2x576x5600 (rows streamed),
            2x576x5601 (streamed as scalar columns), the 900-query shapes
            8x700x900 and 8x128x900 (targets bid) and 2x900x5600, integer ties,
            eps-scaling on 128x128, an iteration cap that leaves -1s; each
            with its cluster plan, and per timed case the microseconds a
            round (kernel_ms over the largest image's rounds); kernel /
            plain / library times (CUDA events; MHA's kernel / library
            ratio), the least time the card
            could take (bytes, operations at 989 TFLOP/s bf16 or 495 / 3
            f32 (3xTF32), or softmax exponentials), and the
            host scipy LAP's time for the auction; serving's pack kernel
            against the host pack, bit for bit, on the serve_b32 pool's
            sizes and odd ones, through a Predictor's pinned staging too,
            timed at B=32 of the pool's mean size beside its bytes bound,
            the host pack it replaces and the staging (``pack_cases``);
            then the attention kernels
            at a few other shapes (ragged tiles, head dims 16 and 64, long
            keys, the float32 MHA at S=1700 and 5600), untimed;
  parity    the full-width stage-2 model (ResNet-50-DC5, 6+6 layers, 576
            queries) in float32 on the card (kernels) against the same
            weights on the CPU (plain versions), one padded 592x592 image;
  serving   a bfloat16 Predictor answers 3 batches of 8 requests of mixed
            sizes; launch counters are zeroed just before and read just
            after (12 RCDA and 6 MHA launches per forward, one pack
            launch a call); then B=32
            all-valid 592x592 forwards are timed and profiled;
  bench     the serving bench entry points as a user runs them, each a
            `python -m` process: countdetr_tpu_torch.bench at its defaults
            but one timing pair (B=32 592x592 bf16 packed uint8, hi=40,
            lo=10, BENCH_PAIRS=1, the profiler's device-envelope estimate)
            and with BENCH_PACKED=0 BENCH_ITERS=8 (float32 images, unpacked
            stem) and with BENCH_DTYPE=float32 BENCH_ITERS=8 (the CLI's
            default dtype, the attention kernels on 3xTF32), each with
            BENCH_PAIRS=1: exit 0, the JAX
            bench's JSON line last (its keys and "device", a finite positive
            value, vs_baseline = round(value / 19, 2)), 12 RCDA, 0 rank-1,
            6 MHA and 0 auction launches a forward on its stderr line; then
            countdetr_tpu_torch.cli.profile_eval --iters 5 (device ms a
            forward by category; its custom-call category non-zero and
            holding the RCDA and MHA kernels); the profiler, wall, busy-time
            and envelope rates and the idle share beside the serving
            phase's b32_img_per_s;
  grad      the kernels' autograd wiring: losses and gradients of a
            full-width 2+2-layer model in float32, B=2 at 256x256 with one
            padded image, on the card against the CPU, given the same match;
            every trainable parameter gets a finite, non-zero gradient;
  train     the stage-2 train step: a bfloat16 Trainer takes 6 steps at
            B=8, 592x592, alternating T=700 (one image with 40 valid
            targets) and T=128 batches; launch counters zeroed before and
            read after (12 RCDA, 6 MHA and 1 auction launch per step);
            finite losses, frozen tensors unchanged, trainable ones moved;
            step time, img/s, matcher time, peak memory, a profiled step;
  stage1_parity  the full-width stage-1 model in float32 on the card
            against the same weights on the CPU, B=2 in a 384x672 bucket
            with one padded image, 700 points of which 500 valid, under
            rcda_variant "v3" and "rank1"; counters zeroed just before each
            card forward and read after (12 launches of the variant's RCDA
            counter, 0 of the other's, 6 MHA);
  stage1_train   stage 1's train path: a bfloat16 stage-1 Trainer takes
            6 steps at B=8, 384x672, the 3 exemplar centres as queries
            (12 RCDA and 6 MHA launches per step); finite losses, frozen
            tensors unchanged, trainable ones moved; step time, img/s, the
            profiler's idle share;
  pseudo_label   stage 1's main path: generate_pseudo_labels over 18
            images of mixed sizes in the three stage-1 buckets, point
            counts in all three tiers (128, 700, 5600; one image with 3700
            points), with perturbed weights, timed under "v3" then
            "rank1" after a warm-up run of each: annotation
            counts equal the points, the two JSONs' w, h within 1 px, 12
            RCDA (resp. 12 rank-1) and 6 MHA launches per forward; images/s,
            points/s and a profiled run of each variant; then one float32
            pass of each variant on the same weights (the CLI's default
            dtype; rank-1's is the path of COUNTDETR_PALLAS_VARIANT=rank1):
            finite boxes, one a point, the same launch counts, rank-1's
            boxes within 1 px of v3's and the count of boxes that differ;
  engine    the training and evaluation engine at full width in bfloat16 on
            a synthetic FSCD-147 tree (48/16/16 JPEGs of 384x576, 4-400
            objects): FSC147Pseudo read raw uint8 into a shuffled Batcher
            with 2 workers and box tiers (128, 700, 5600); train_one_epoch
            for epoch 0, an AsyncSaver checkpoint, epoch 1; a second
            Trainer restored from the checkpoint (weights, AdamW moments,
            scheduler position and bad_steps bit-equal to the first's at
            the save) runs epoch 1 again (mean loss within rtol 1e-2);
            evaluate on val, infer_detections on test with its predictions
            JSON, counting_summary and COCO AP; stage 1 under "rank1": one
            epoch of 6 steps on FSCD147Exemplars and stage1_test. Per loop:
            launch counts (12/6/1 a stage-2 step, 12/6 a forward), wall
            seconds, img/s, peak memory, host seconds by phase and, for
            the profiled loops, the device idle share; the auction's rounds
            per image of epoch 0 and how many hit the cap. JSONs land in
            --out (the checkpoint's meta and latest.json, not its ~0.5 GB
            payload).
  defaults  the JAX CLI's default model options (ResNet-50-DC5, 6+6 layers,
            the learned prior of 300 x 3 = 900 queries): float32 card-vs-CPU
            parity at B=2 (one padded 592x592 image) under the learned and
            the sampled (300 points) prior, the auxiliary outputs included;
            a bfloat16 Predictor serves 3 batches of 32 at 592x592 (12 RCDA
            and 6 MHA launches a forward) and the B=32 forward is timed; 6
            bfloat16 Trainer steps at B=8 with aux_loss and dropout 0.1 (12
            RCDA, 6 MHA and 6 auction launches a step: one matching a
            decoder layer, each its own launch), then 3 under the sampled
            prior (12/6/1); finite losses, every trainable tensor moved,
            step and matcher times;
  longtail  AnchorDETR's remaining model options at full width: A, standard
            attention in stage 2 (576 grid queries; 18 MHA launches a
            forward); B, three feature levels in stage 1 (9 RCDA or rank-1
            and 9 MHA); C, the mask head in stage 2 (12 RCDA and 6 MHA). The
            MHA kernel against its plain version in bfloat16 and float32 at
            the shapes they give it: B=32 L=S=1369 (A's encoder, image 0's
            keys padded), B=32 L=576 S=1369 (A's cross-attention), B=8064
            and B=70000 L=S=3 (B's level layer, one row a pixel; 70000 is
            past gridDim.z's 65535), each timed with its bound and SDPA;
            float32 card-vs-CPU parity of A (B=2 at 592x592, one padded),
            B under "v3" and "rank1" (B=2, 384x672) and C (B=1, pred_masks
            compared); serving A, 3 batches of 32 (54 MHA launches); 6
            bfloat16 train steps of A (B=8 at 592x592, T=700 and 128; an
            auction a step) and of B (B=8, 384x672); pseudo-labels under B
            with each variant, boxes within 1 px; the mask head served at
            B=2 (pred_masks (2, 576, 148, 148), ms a forward with and
            without the head, peak memory); the CLI with each of the three flag
            values, 2 train steps and then --infer (stage 1: --test), on a
            16/8/8-image tree of the cli phase's shape, each mode's stdout
            in --out/longtail/;
  cli       the port's command line at full width in bfloat16 on a
            synthetic FSCD-147 tree of the engine's shape without pseudo
            labels: stage-1 train (6 steps, rank-1), --generate_pseudo_label
            into the tree (a box for every dot), stage-2 train for 2 epochs
            cut by --max_steps, the same with --auto_resume and --epochs 3
            (resumed at epoch 2 at the saved optimizer step), --eval,
            --infer, --evaluate_predictions as a `python -m` subprocess (its
            counting metrics equal metrics.json's), stage-1 --test (rank-1),
            a bare --stage 2 (the learned prior) for 3 steps and --infer
            from its checkpoint, and cli/bench.py's train, match, e2e and
            flops modes; per mode
            the wall seconds, img/s, forwards and launches (12 RCDA or
            rank-1 and 6 MHA a forward, 1 auction a stage-2 train or eval
            step), the files written, peak memory and no worker process
            left; the modes' output in --out/cli/;
  ddp       data parallelism at full width (stage2_config, 576 queries):
            (a) a world of 2 processes over gloo on the one card (spawned
            after the kernels are built; NCCL refuses two ranks on one
            device, which the ranks then show by trying it) trains 4
            float32 steps at B=8 a rank (global batches of 16 at 592x592,
            T=700 and 128 in turns, image 0 with 40 valid targets) against
            one process taking the same global batches: the losses and
            gradient norm within DDP_TOL, the weights within the Adam bound,
            the assignments compared row by row, 12 RCDA, 6 MHA and 1
            auction launch a step on each rank; (b) a world of 1 over NCCL:
            bfloat16 steps of the DDP Trainer and the bare one in turns (the
            wrapper's overhead), one profiled DDP step read by
            utils/xprof.py from the live profiler and from its Chrome trace
            (device ms by category, the all-reduce kernels, the step's
            record_function range); (c) an uneven epoch of 19 samples
            (global batches of 16 and 3: rank 1's second slice is padding
            only) through train_one_epoch, the same losses on both ranks;
            (d) the world's checkpoint, written by rank 0, restored in one
            process bit-equal to both ranks' states (sha256 of each
            tensor); (e) remat on against off at B=8: float32 loss and
            gradients on the same match, then bfloat16 steps of each, their
            time, peak memory and launches (24 RCDA and 12 MHA a step under
            remat: the recompute launches the forward kernels again);
  tp        tensor parallelism at full width (stage2_config: 8 heads, 4 a
            rank; FFN 1024, 512 a rank), worlds spawned after the build
            over gloo on the one card: (a) 2 processes, mesh (data=1,
            model=2), float32: the forward at B=2, 592x592, one image
            padded, within 1e-4 of one process; 2 Trainer steps on global
            batches of 8 (T=700 and 128 in turns, image 0 with 40 valid
            targets), replaying one process's match, against that process:
            losses and gradient norm within DDP_TOL, weights within the
            Adam bound, the replicated parameters bit-equal across the
            ranks, 12 RCDA, 6 MHA and 1 auction launch a step on each rank;
            (b) 4 processes, mesh (2, 2), 2 steps at B=4 a data rank, the
            same checks; (c) (b)'s checkpoint, gathered and written by rank
            0, restored in one process to the world's gathered state
            (sha256 of each tensor), and the shard-then-gather round trip
            bit-equal on every rank; (d) RCDA v3, rank-1 and MHA at a model
            rank's shapes (E=128, 4 heads: RCDA and MHA at B=32, L=1369 and
            576, bfloat16 and float32; rank-1 at stage 1's B=8 24x42)
            against their plain versions, timed with their bounds; (e)
            bfloat16 steps at B=8, (a)'s world against one process (medians
            of 8, each rank's peak memory);
Then (after the cli phase, the longtail, ddp and tp phases) the kernels line
with each path's launch counts (its "launches": the cli phase's pipeline
modes), the card's nvidia-smi line, and last {"ok": true, "device": {...}}.
Any failure exits non-zero; without a CUDA device nothing is printed on
stdout.

    python3 chip_smoke.py --only auction rank1   # bring-up: build, then
                                                 # only these kernels' cases
                                                 # (rcda, rank1, mha, auction,
                                                 # pack;
                                                 # rcda and mha add their
                                                 # float32 rows of PERF.md,
                                                 # rank1 its tp-rank rows;
                                                 # each its determinism check)
    python3 chip_smoke.py --only bench           # build, then only the
                                                 # bench phase
    python3 chip_smoke.py --only engine          # likewise, the engine phase
    python3 chip_smoke.py --only cli             # likewise, the cli phase
    python3 chip_smoke.py --only defaults        # likewise, the defaults phase
    python3 chip_smoke.py --only longtail        # likewise, the longtail phase
    python3 chip_smoke.py --only ddp             # likewise, the ddp phase
    python3 chip_smoke.py --only tp              # likewise, the tp phase
    python3 chip_smoke.py --only convergence     # the learning-loop check

A run of phases (--only and phase names) ends, when they pass, with the
nvidia-smi line and the {"ok": true, ...} line, as the whole run does.

The ``convergence`` phase runs only when asked for:
tests/torch_convergence_run.py in bfloat16, the JAX package's learning-loop
recipe (synthetic FSCD-147, 300 stage-1 steps, pseudo-labels, 1500 stage-2
steps), held to its held-out bounds (test AP50 > 0.5, MAE@0.5 < 1.0, train
AP50 > 0.5); its log in --out/convergence.txt. The recipe misses those
bounds in the JAX package too (PERF.md §6), so the whole run leaves it
out.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from countdetr_tpu_torch.utils.trace import launch_counts, reset_launches

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("bench", "engine", "cli", "defaults", "longtail", "ddp", "tp",
          "convergence")  # with --only

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s by type.
# A float32 product on the tensor cores is three TF32 products (3xTF32, the
# f32 attention kernels), so f32 operations are bounded at 495 / 3 TFLOP/s;
# CUDA_CORE_F32 (67 TFLOP/s outside the tensor cores) bounds the auction's
# scans, and each f32 attention case also reports its bound at that rate
# (``cuda_core_bound_ms``), the bound of the CUDA-core float32 kernels.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
CUDA_CORE_F32 = 67e12
TOL = {torch.bfloat16: {"rcda": 2e-2, "mha": 1e-2}, torch.float32: {"rcda": 1e-4, "mha": 1e-4}}
# bfloat16 MHA: each output element within max(1e-2, one bf16 ulp of the
# plain version's |output|) (``mha_errors``): at |output| >= 2 one bf16 ulp
# is already larger than 1e-2. Both versions also round each probability
# to bf16 once, and two correct roundings of p_j differ by up to one ulp,
# which moves the output by ulp(p_j) |v_j|: the sum of that over the keys
# is added (``mha_p_rounding``; it matters where a row has few keys, as
# the level layer's 3, where one probability near 1 meets |v| ~ 5).
MHA_BF16_TOL = "max(1e-2, 1 bf16 ulp of |ref|) + sum_j ulp(p_j) |v_j|"
PARITY_TOL = 1e-3
GRAD_TOL = 1e-3  # relative: max |card - cpu| / max |cpu|
EXEMPLARS = [[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6], [0.2, 0.5, 0.4, 0.7]]


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Exponentials a second: 16 ex2 a clock on each SM's special function units
# at the card's maximum SM clock (set by ``card_rates`` from nvidia-smi)
EX2_PER_S = None


def card_rates():
    """SM count, maximum SM clock (nvidia-smi clocks.max.sm) and the ex2 rate
    they give; sets EX2_PER_S for ``bound``."""
    global EX2_PER_S
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EX2_PER_S = 16 * sms * mhz * 1e6
    return {"sms": sms, "max_sm_mhz": mhz, "ex2_per_s": EX2_PER_S}


def bound(ops, nbytes, dtype, exps=0, peak=None):
    """The least milliseconds for the work, and what sets it: the operations
    at the dtype's peak (or ``peak`` op/s), the bytes at the memory rate, or
    the softmax exponentials at the SFU rate."""
    t = {"operations": ops / (peak or PEAK_OPS[dtype]), "bytes": nbytes / HBM_BYTES_PER_S,
         "exp": exps / EX2_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


# stage 1's RCDA calls: B=8 in the 384x672 bucket, C5 24x42, image 1 padded
STAGE1_SHAPE = dict(B=8, H=24, W=42, pad=(34, 20))
# the COCO detector's C5 grids in its 800x1344 and 1344x800 buckets, with the
# (columns, rows) an 800x1067 image keeps
COCO_GRIDS = ((50, 84, (67, 50)), (84, 50, (50, 67)))


def rcda_case(rcda_kernel, g, dt, L, B=32, H=37, W=37, E=256, n=8, variant="v3", pad=(30, 25)):
    """One RCDA core call of ``variant`` against its plain version; image 1
    padded to ``pad`` (columns, rows), image 3 to 5 columns. ``source`` is
    the csrc/ file that ran (a float32 call of either variant: rcda.cu)."""
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    d = E // n
    q_row, q_col = (r(B, L, E) * d**-0.5).to(dt), (r(B, L, E) * d**-0.5).to(dt)
    k_row, k_col, v = r(B, W, E).to(dt), r(B, H, E).to(dt), r(B, H, W, E).to(dt)
    bias_row = torch.zeros(B, W, device=dev)
    bias_col = torch.zeros(B, H, device=dev)
    bias_row[1, pad[0]:] = -1e30  # one image padded on the right and bottom
    bias_col[1, pad[1]:] = -1e30
    bias_row[3, 5:] = -1e30  # one narrow image
    args = (q_row, q_col, k_row, k_col, v, bias_row.to(dt), bias_col.to(dt), n)
    plain = rcda_kernel.PLAIN[variant]
    got = rcda_kernel.rcda_core(*args, variant)
    torch.cuda.synchronize()
    want = plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    isz = torch.tensor([], dtype=dt).element_size()
    # both score products and the combine (v3: two stages, the H*d
    # intermediate weighted by a_col; rank1: one H*W contraction plus the
    # products that form P)
    ops = 2 * B * L * E * (H + W) + 2 * B * L * E * H * W
    ops += 2 * B * L * E * H if variant == "v3" else B * n * L * H * W
    nbytes = isz * (2 * B * L * E + B * (W + H) * E + B * H * W * E + B * (W + H) + B * L * E)
    exps = B * n * L * (H + W)  # one per score of both softmaxes
    bound_ms, bound_by = bound(ops, nbytes, dt, exps)
    rec = {
        "variant": variant, "shape": {"B": B, "L": L, "H": H, "W": W, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "tol": TOL[dt]["rcda"], "finite": bool(torch.isfinite(got).all()),
        "kernel_ms": cuda_ms(lambda: rcda_kernel.rcda_core(*args, variant), 20),
        "plain_ms": cuda_ms(lambda: plain(*args), 5),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6, "gexp": exps / 1e9,
        "source": rcda_kernel.kernel_route(variant, dt, H, W, d)[0],
    }
    if dt == torch.float32:
        rec["cuda_core_bound_ms"] = bound(ops, nbytes, dt, exps, peak=CUDA_CORE_F32)[0]
        rec["route"] = rcda_kernel.f32_route(H, W, d)
    return rec


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 significand bits), float32."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), torch.frexp(x.float())[1] - 8)


def mha_p_rounding(q, k, v, bias, n):
    """sum_j ulp(p_j) |v_j| for each output element (B, L, E) float32: what
    one bf16 rounding of each probability can move it by."""
    B, L, E = q.shape
    d = E // n
    logits = torch.einsum("blnd,bsnd->bnls", q.reshape(B, L, n, d).float(),
                          k.reshape(B, -1, n, d).float())
    p = torch.softmax(logits + bias.float()[:, None, None, :], dim=-1)
    del logits
    return torch.einsum("bnls,bsnd->blnd", bf16_ulp(p),
                        v.reshape(B, -1, n, d).float().abs()).reshape(B, L, E)


def mha_errors(got, want, dt, p_rounding=None):
    """(largest |error|, largest error in bf16 ulps of |want|, the largest
    share of its tolerance an element uses): bfloat16 each element within
    MHA_BF16_TOL (``p_rounding`` from ``mha_p_rounding``), float32 all
    within TOL[float32]["mha"]; within when the share is at most 1."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulp = bf16_ulp(w)
    ulps = (err / ulp).max().item()
    if dt == torch.bfloat16:
        tol = ulp.clamp(min=TOL[dt]["mha"]) + (0 if p_rounding is None else p_rounding)
        share = (err / tol).max().item()
    else:
        share = err.max().item() / TOL[dt]["mha"]
    return err.max().item(), ulps, share


def mha_case(mha_kernel, g, dt, B=32, L=576, E=256, n=8, S=None, key_grid=None, time_it=True):
    """One MHA core call against its plain version, timed with SDPA beside
    it. S keys (default L); image 0's keys partly masked (past key 500, or
    with ``key_grid`` (H, W, h, w) the padding of an H x W grid around its
    top-left h x w), image 1's all masked (the uniform softmax)."""
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    d = E // n
    S = L if S is None else S
    q, k, v = (r(B, L, E) * d**-0.5).to(dt), r(B, S, E).to(dt), r(B, S, E).to(dt)
    bias = torch.zeros(B, S, device=dev)
    if key_grid is None:
        bias[0, 500:] = -1e30  # partly masked keys
    else:
        H, W, h, w = key_grid
        pad = torch.ones(H, W, dtype=torch.bool, device=dev)
        pad[:h, :w] = False
        bias[0, pad.flatten()] = -1e30
    bias[1, :] = -1e30  # every key masked: uniform softmax
    got = mha_kernel.mha_core(q, k, v, bias, n)
    torch.cuda.synchronize()
    want = mha_kernel.mha_core_plain(q, k, v, bias, n)
    p_rounding = mha_p_rounding(q, k, v, bias, n) if dt == torch.bfloat16 else None
    err, err_ulps, share = mha_errors(got, want, dt, p_rounding)
    del want, p_rounding
    dead = got[1].float()
    dead_err, _, dead_share = mha_errors(dead, v[1].float().mean(0, keepdim=True).expand_as(dead),
                                         dt)
    isz = torch.tensor([], dtype=dt).element_size()
    ops = 4 * B * L * S * E
    nbytes = isz * 2 * B * (L + S) * E + 4 * B * S
    exps = B * n * L * S  # one per score
    bound_ms, bound_by = bound(ops, nbytes, dt, exps)
    f32 = {}
    if dt == torch.float32:
        f32["cuda_core_bound_ms"] = bound(ops, nbytes, dt, exps, peak=CUDA_CORE_F32)[0]
    rec = {
        "shape": {"B": B, "L": L, "S": S, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "max_err_ulps": err_ulps,
        "tol": MHA_BF16_TOL if dt == torch.bfloat16 else TOL[dt]["mha"],
        "tol_share": share, "within_tol": share <= 1,
        "finite": bool(torch.isfinite(got).all()),
        "dead_row_finite": bool(torch.isfinite(dead).all()),
        "dead_row_uniform_err": dead_err, "dead_row_within_tol": dead_share <= 1,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6, "gexp": exps / 1e9, **f32,
    }
    if not time_it:
        return rec
    qh = q.view(B, L, n, d).transpose(1, 2)
    kh, vh = (x.view(B, S, n, d).transpose(1, 2) for x in (k, v))
    mask = bias[:, None, None, :].to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["kernel_ms"] = cuda_ms(lambda: mha_kernel.mha_core(q, k, v, bias, n), 20)
    rec["plain_ms"] = cuda_ms(lambda: mha_kernel.mha_core_plain(q, k, v, bias, n),
                              5 if L * S <= 1024 * 1024 else 2, warmup=1)
    try:
        rec["library_ms"] = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0), 20)
        rec["kernel_over_library"] = rec["kernel_ms"] / rec["library_ms"]
    except RuntimeError as e:  # SDPA's own launch limits
        rec["library_ms"], rec["library_error"] = None, str(e)[:200]
    return rec


def edge_cases(rcda_kernel, mha_kernel, g, kinds=("rcda", "mha")):
    """The attention kernels off the main path's shapes: ragged query tiles,
    key counts that are not a multiple of 16 or of the key tile, W < 16, head
    dims 16 and 64, both RCDA variants, MHA over long keys in both dtypes
    (the float32 kernel at S=1700 and 5600 too); each against its plain
    version, untimed."""
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = []
    variants = [v for v in rcda_kernel.PLAIN if "rcda" in kinds or v in kinds]
    for dt in (torch.bfloat16, torch.float32):
        rcda_shapes = ((2, 50, 7, 5, 64, 4), (3, 97, 9, 13, 128, 2), (1, 130, 64, 3, 64, 2))
        for B, L, H, W, E, n in rcda_shapes if variants else ():
            q_row, q_col = (r(B, L, E) * (E // n) ** -0.5).to(dt), (r(B, L, E) * (E // n) ** -0.5).to(dt)
            k_row, k_col, v = r(B, W, E).to(dt), r(B, H, E).to(dt), r(B, H, W, E).to(dt)
            bias_row, bias_col = torch.zeros(B, W, device=dev), torch.zeros(B, H, device=dev)
            bias_row[-1, W // 2 + 1:] = -1e30
            bias_col[-1, H // 2 + 1:] = -1e30
            args = (q_row, q_col, k_row, k_col, v, bias_row.to(dt), bias_col.to(dt), n)
            for variant in variants:
                err = (rcda_kernel.rcda_core(*args, variant).float()
                       - rcda_kernel.PLAIN[variant](*args).float()).abs().max().item()
                out.append({"name": f"rcda {variant}", "shape": [B, L, H, W, E, n],
                            "dtype": str(dt)[6:], "max_abs_err": err, "tol": TOL[dt]["rcda"]})
        mha_shapes = [(2, 40, 23, 64, 4), (2, 70, 130, 128, 2), (1, 5, 1, 32, 1),
                      (2, 70, 1700, 128, 2), (1, 33, 1601, 64, 2), (1, 20, 2000, 64, 4)]
        if dt == torch.float32:  # the model's width over the long point tiers
            mha_shapes += [(1, 33, 1700, 256, 8), (1, 33, 5600, 256, 8)]
        for B, L, S, E, n in mha_shapes if "mha" in kinds else ():
            q = (r(B, L, E) * (E // n) ** -0.5).to(dt)
            k, v = r(B, S, E).to(dt), r(B, S, E).to(dt)
            bias = torch.zeros(B, S, device=dev)
            bias[0, S // 2 + 1:] = -1e30
            err, ulps, share = mha_errors(
                mha_kernel.mha_core(q, k, v, bias, n), mha_kernel.mha_core_plain(q, k, v, bias, n),
                dt, mha_p_rounding(q, k, v, bias, n) if dt == torch.bfloat16 else None)
            out.append({"name": "mha", "shape": [B, L, S, E, n], "dtype": str(dt)[6:],
                        "max_abs_err": err, "max_err_ulps": ulps, "tol_share": share,
                        "within_tol": share <= 1,
                        "tol": MHA_BF16_TOL if dt == torch.bfloat16 else TOL[dt]["mha"]})
    return out


def f32_determinism(rcda_kernel, mha_kernel, g, kinds=("rcda", "rank1", "mha"), reps=10):
    """The float32 kernels at the ddp phase's shapes, one process's batch of
    16 at 592x592 (37x37; RCDA over L=1369 and 576 queries, MHA over L=S=576,
    image 1 padded), and rank-1 (rcda.cu's kernel under its rank-1 caller)
    at stage 1's, a batch of 16 in the 384x672 bucket (24x42, L=1008, image
    1 padded): ``reps`` more calls on the same inputs bit-equal to the
    first (deterministic), and each rank's half of the batch on its own
    bit-equal to its rows of the whole (batch-invariant)."""
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    B, E, n, H, W = 16, 256, 8, 37, 37
    calls = []
    if "rcda" in kinds:
        bias_row, bias_col = torch.zeros(B, W, device=dev), torch.zeros(B, H, device=dev)
        bias_row[1, 30:] = -1e30
        bias_col[1, 25:] = -1e30
        for L in (1369, 576):
            xs = [r(B, L, E) * 32**-0.5, r(B, L, E) * 32**-0.5, r(B, W, E), r(B, H, E),
                  r(B, H, W, E), bias_row, bias_col]
            calls.append((f"rcda L={L}", lambda *a: rcda_kernel.rcda_core(*a, n, "v3"), xs))
    if "mha" in kinds:
        bias = torch.zeros(B, 576, device=dev)
        bias[1, 500:] = -1e30
        xs = [r(B, 576, E) * 32**-0.5, r(B, 576, E), r(B, 576, E), bias]
        calls.append(("mha L=S=576", lambda *a: mha_kernel.mha_core(*a, n), xs))
    if "rank1" in kinds:
        H1, W1, (pw, ph) = STAGE1_SHAPE["H"], STAGE1_SHAPE["W"], STAGE1_SHAPE["pad"]
        bias_row, bias_col = torch.zeros(B, W1, device=dev), torch.zeros(B, H1, device=dev)
        bias_row[1, pw:] = -1e30
        bias_col[1, ph:] = -1e30
        xs = [r(B, 1008, E) * 32**-0.5, r(B, 1008, E) * 32**-0.5, r(B, W1, E), r(B, H1, E),
              r(B, H1, W1, E), bias_row, bias_col]
        calls.append(("rcda_rank1 L=1008 24x42",
                      lambda *a: rcda_kernel.rcda_core(*a, n, "rank1"), xs))
    out = []
    for name, fn, xs in calls:
        whole = fn(*xs)
        deterministic = all(torch.equal(fn(*xs), whole) for _ in range(reps))
        halves = [fn(*(x[i:i + B // 2] for x in xs)) for i in (0, B // 2)]
        out.append({"name": name, "dtype": "float32", "batch": B, "halves": B // 2,
                    "repeats": reps, "deterministic": deterministic,
                    "batch_invariant": torch.equal(torch.cat(halves), whole)})
    return out


def f32_cases(rcda_kernel, mha_kernel, g, kinds):
    """The float32 attention rows of PERF.md that the default-dtype paths
    launch, timed: RCDA v3 at serving B=32 (L=1369, 576), stage 1's B=8
    24x42 (L=1008, 700), a TP rank's E=128 (L=1369, 576) and the COCO
    detector's B=8 50x84 and 84x50 (L=4200, 900; two 64-wide chunks); MHA at B=8
    S=700 / 576 (the decoder's self-attention over the point tiers), the
    longtail shapes (standard attention's encoder and cross-attention at
    B=32, the level layer) and a TP rank's (L=S=1369 over the grid, 576);
    the determinism check of each of ``kinds`` (rank-1's rows are the
    ``rank1`` cases of ``only_kernels``)."""
    f32 = torch.float32
    rec = {}
    if "rcda" in kinds:
        rec["rcda"] = [rcda_case(rcda_kernel, g, f32, L) for L in (1369, 576)]
        rec["rcda"] += [rcda_case(rcda_kernel, g, f32, L, **STAGE1_SHAPE) for L in (1008, 700)]
        rec["rcda"] += [rcda_case(rcda_kernel, g, f32, L, E=TP_E, n=TP_HEADS)
                        for L in (1369, 576)]
        # the COCO detector's B=8 grids past a 64-wide axis (detr_coco_b8):
        # the 3xTF32 kernel in two chunks, an 800 x 1067 image padded in its
        # bucket
        rec["rcda"] += [rcda_case(rcda_kernel, g, f32, L, B=8, H=H, W=W, pad=pad)
                        for H, W, pad in COCO_GRIDS for L in (H * W, 900)]
    if "mha" in kinds:
        rec["mha"] = [mha_case(mha_kernel, g, f32, B=8, L=L) for L in (700, 576)]
        rec["mha"] += [mha_case(mha_kernel, g, f32, B=B, L=L, S=S, key_grid=grid)
                       for B, L, S, grid in LONGTAIL_MHA]
        rec["mha"] += [mha_case(mha_kernel, g, f32, B=32, L=L, key_grid=grid, E=TP_E,
                                n=TP_HEADS) for L, grid in ((1369, (37, 37, 30, 25)), (576, None))]
    rec["determinism"] = f32_determinism(rcda_kernel, mha_kernel, g, kinds)
    return rec


def in_tol(c):
    """A kernel case within its tolerance (MHA's own verdict, else the
    largest error against ``tol``)."""
    return c["within_tol"] if "within_tol" in c else c["max_abs_err"] <= c["tol"]


def cost_structures(rng, B, Q, T):
    """The matcher's three cost structures (countdetr_tpu/cli/bench.py
    match_bench): random, DETR-shaped (spatial L1 + class), and degenerate
    near-identical rows, the worst case for the auction's contention."""
    pb = rng.uniform(0.1, 0.9, (B, Q, 2))
    tb = rng.uniform(0.1, 0.9, (B, T, 2))
    l1 = np.abs(pb[:, :, None] - tb[:, None, :]).sum(-1)
    base = rng.normal(size=(B, 1, T))
    return {
        "random": (rng.normal(size=(B, Q, T)) * 5).astype(np.float32),
        "detr": (5 * l1 + 2 * rng.uniform(-1, 0, (B, Q, 1))).astype(np.float32),
        "degenerate": (base + rng.normal(size=(B, Q, T)) * 1e-4).astype(np.float32),
    }


def auction_case(auction_kernel, name, benefit, active, eps, cap, scaling=False, cost=None,
                 valid=None, sweep=()):
    """The kernel against its plain version on one auction problem, tolerance
    0 on assignments, rounds and bids, with the cluster plan it ran on. With
    ``cost`` (numpy, the matcher's (B, Q, T)) it is timed, bounded and set
    beside the host scipy LAP; each cluster size in ``sweep`` is run, held
    to the same answers and timed too."""
    args = (benefit, active, eps, cap, scaling)
    got, rounds, bids = auction_kernel.auction_assign(*args, with_stats=True)
    torch.cuda.synchronize()
    plain = {}  # the compared run is the timed one (the plain rounds take seconds)
    plain_ms = cuda_ms(lambda: plain.setdefault(
        "out", auction_kernel.auction_plain(*args, with_stats=True)), 1, warmup=0)
    want, w_rounds, w_bids = plain["out"]
    B, P, O = benefit.shape
    C, resident, smem = auction_kernel.cluster_plan(B, P, O)
    rec = {
        "case": name, "shape": {"B": B, "P": P, "O": O}, "scaling": scaling, "max_iters": cap,
        "cluster": C, "resident": resident, "smem_per_block": smem,
        "max_active_clusters": auction_kernel.max_active_clusters(P, O, C, resident),
        "identical": bool(torch.equal(got, want) and torch.equal(rounds, w_rounds)
                          and torch.equal(bids, w_bids)),
        "max_abs_err": float((got - want).abs().max().item()),
        "tol": 0, "unassigned": int((got < 0).sum().item()),
        "rounds": rounds.tolist(), "plain_rounds": w_rounds.tolist(), "bids": bids.tolist(),
    }
    if cost is not None:
        from countdetr_tpu_torch.ops.matching import scipy_match

        # the least time: the inputs read once and the assignment written
        # once, or this run's scans in f32, one subtract and one compare per
        # bid and object; the rows that each round re-reads (l2_mbytes, from
        # shared memory when resident) are traffic the kernel chooses, not
        # the function's
        nbytes = (benefit.numel() * benefit.element_size() + active.numel() * active.element_size()
                  + eps.numel() * eps.element_size() + got.numel() * got.element_size())
        n_bids = float(bids.sum().item())
        ops = 2 * n_bids * O
        bound_ms, bound_by = bound(ops, nbytes, torch.float32, peak=CUDA_CORE_F32)
        kernel_ms = cuda_ms(lambda: auction_kernel.auction_assign(*args), 5)
        rec.update({
            "kernel_ms": kernel_ms, "us_per_round": kernel_ms * 1e3 / max(1, int(rounds.max())),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": ops / 1e9,
            "mbytes": nbytes / 1e6, "l2_mbytes": n_bids * O * 4 / 1e6, "library_ms": None,
        })
        t = time.perf_counter()
        scipy_match(cost, valid)
        rec["scipy_host_ms"] = (time.perf_counter() - t) * 1e3  # host time, not the card's
    rec["sweep"] = []
    for c in sweep:
        g2, r2, b2 = auction_kernel.auction_assign(*args, with_stats=True, cluster=c)
        Cs, res_s, smem_s = auction_kernel.cluster_plan(B, P, O, c)
        ms = cuda_ms(lambda: auction_kernel.auction_assign(*args, cluster=c), 5)
        rec["sweep"].append({
            "cluster": Cs, "resident": res_s, "smem_per_block": smem_s,
            "max_active_clusters": auction_kernel.max_active_clusters(P, O, Cs, res_s),
            "identical": bool(torch.equal(g2, want) and torch.equal(r2, w_rounds)
                              and torch.equal(b2, w_bids)),
            "kernel_ms": ms, "us_per_round": ms * 1e3 / max(1, int(r2.max()))})
    return rec


def auction_cases(auction_kernel, matching, rng):
    dev = torch.device("cuda")
    cases = []

    def from_cost(name, cost, valid, timed, cap=None, sweep=()):
        c, v = torch.from_numpy(cost).to(dev), torch.from_numpy(valid).to(dev)
        benefit, active, eps, iters_cap, squared = matching.auction_inputs(c, v)
        cases.append(auction_case(auction_kernel, name, benefit, active, eps, cap or iters_cap,
                                  squared, cost=cost if timed else None, valid=valid,
                                  sweep=sweep))

    B, Q = 8, 576
    valid700 = np.ones((B, 700), bool)
    valid700[0, 40:] = False  # one sparse image
    for name, cost in cost_structures(rng, B, Q, 700).items():
        # the main shape also on clusters of 4 (rows streamed), 8 and 16
        from_cost(f"576x700 {name}", cost, valid700, timed=True,
                  sweep=(4, 8, 16) if name == "detr" else ())
    # more clusters than the card holds at once: one sparse image in each half
    valid16 = np.ones((16, 700), bool)
    valid16[[0, 8], 40:] = False
    from_cost("576x700 detr B=16", cost_structures(rng, 16, Q, 700)["detr"], valid16,
              timed=False)
    valid128 = np.ones((B, 128), bool)
    valid128[0, 40:] = False
    from_cost("576x128 detr (targets bid)", cost_structures(rng, B, Q, 128)["detr"], valid128,
              timed=True)
    valid5600 = np.zeros((2, 5600), bool)
    valid5600[:, :3000] = True
    from_cost("576x5600 detr, 3000 valid", cost_structures(rng, 2, Q, 5600)["detr"], valid5600,
              timed=True)
    # rows streamed as scalar columns: O not a multiple of 4
    valid5601 = np.zeros((2, 5601), bool)
    valid5601[:, :3001] = True
    from_cost("576x5601 detr, 3001 valid (scalar rows)", cost_structures(rng, 2, Q, 5601)["detr"],
              valid5601, timed=False)
    from_cost("576x700 detr, cap 5", cost_structures(rng, B, Q, 700)["detr"], valid700,
              timed=False, cap=5)
    for Bi, P, O in ((3, 23, 43), (2, 5, 5), (2, 2, 30), (1, 1, 9)):  # exact ties
        cost = rng.integers(-4, 4, size=(Bi, P, O)).astype(np.float32)
        active = rng.random((Bi, P)) < 0.8
        span = np.maximum(cost.max((1, 2)) - cost.min((1, 2)), 1e-3)
        cases.append(auction_case(
            auction_kernel, f"integer ties {Bi}x{P}x{O}",
            torch.from_numpy(np.where(active[:, :, None], -cost, 0.0).astype(np.float32)).to(dev),
            torch.from_numpy(active).to(dev),
            torch.from_numpy((span * 1e-3).astype(np.float32)).to(dev), 16 * O + 2048))
    cost = (rng.normal(size=(2, 128, 128)) * 5).astype(np.float32)
    span = np.maximum(cost.max((1, 2)) - cost.min((1, 2)), 1e-3)
    cases.append(auction_case(
        auction_kernel, "scaling 128x128", torch.from_numpy(-cost).to(dev),
        torch.ones((2, 128), dtype=torch.bool, device=dev),
        torch.from_numpy((span * 1e-3).astype(np.float32)).to(dev), 16 * 128 + 2048,
        scaling=True))
    # 900 queries (the learned prior's 300 x 3): the 700 and 128 box tiers
    # bid as targets; the 5600 tier is transposed, the queries bidding
    from_cost("900x700 detr (targets bid)", cost_structures(rng, B, 900, 700)["detr"],
              valid700, timed=True)
    from_cost("900x128 detr (targets bid)", cost_structures(rng, B, 900, 128)["detr"],
              valid128, timed=True)
    from_cost("900x5600 detr, 3000 valid", cost_structures(rng, 2, 900, 5600)["detr"],
              valid5600, timed=True)
    return cases


def perturb_(model, seed):
    """Seeded noise on every parameter outside the backbone, so the
    zero-initialised ones (the bbox head's last weight, attention biases)
    pass gradients on."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("backbone"):
                p.add_((torch.randn(p.shape, generator=g) * 0.02).to(p.device))


def train_batch(rng, B, size, T, n_valid_first=None, pad=None):
    """A Batcher-format stage-2 batch: packed uint8 images, targets cxcywh;
    image 0 keeps its first ``n_valid_first`` targets, image 1 is padded to
    ``pad`` (h, w) when given."""
    from countdetr_tpu_torch.data.batching import pack_space_to_depth

    raw = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    mask = np.zeros((B, size, size), bool)
    if pad is not None:
        mask[1, pad[0]:, :] = True
        mask[1, :, pad[1]:] = True
        raw[mask] = 0
    boxes = rng.uniform(0.2, 0.7, (B, T, 4)).astype(np.float32)
    boxes[..., 2:] = np.clip(boxes[..., 2:], 0.02, 0.2)
    valid = np.ones((B, T), bool)
    if n_valid_first is not None:
        valid[0, n_valid_first:] = False
    return {"images": pack_space_to_depth(raw), "pad_mask": mask,
            "exemplar_boxes": np.tile(np.asarray(EXEMPLARS, np.float32)[None], (B, 1, 1)),
            "boxes": boxes, "boxes_valid": valid, "batch_valid": np.ones(B, bool)}


def grad_phase(rng, failures):
    """Autograd through the kernels on the card against the plain path on
    the CPU, float32, same weights, same batch, the card's match."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops.losses import MatchedTargets
    from countdetr_tpu_torch.train.train_step import prepare_stage2_batch, stage2_loss

    cfg, tcfg = stage2_config(enc_layers=2, dec_layers=2), TrainConfig()
    cpu_model = build_model(cfg, device="cpu", seed=1)
    perturb_(cpu_model, 1)
    gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict()).train()
    cpu_model.train()
    batch = train_batch(rng, 2, 256, 64, n_valid_first=30, pad=(200, 176))
    reset_launches()
    total_g, parts_g, match = stage2_loss(gpu_model, prepare_stage2_batch(batch, "cuda"), tcfg)
    total_g.backward()
    torch.cuda.synchronize()
    launches = launch_counts()
    want_launches = {"rcda": 4, "rcda_rank1": 0, "mha": 2, "auction": 1, "pack": 0}
    if launches != want_launches:
        failures.append(("grad launches", launches, want_launches))
    cpu_match = MatchedTargets(*(None if x is None else x.cpu() for x in match))
    total_c, parts_c, _ = stage2_loss(cpu_model, prepare_stage2_batch(batch, "cpu"), tcfg,
                                      match=cpu_match)
    total_c.backward()

    losses = {}
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance"):
        a, b = parts_g[k].item(), parts_c[k].item()
        losses[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / max(abs(b), 1e-12)}
        if not losses[k]["rel_err"] <= GRAD_TOL:
            failures.append(("grad loss", k, losses[k]))
    cpu_params = dict(cpu_model.named_parameters())
    checked = {}
    for name, p in gpu_model.named_parameters():
        if name.endswith("attn.in_proj_weight") or name == "backbone.body.layer4.0.conv2.weight":
            want = cpu_params[name].grad
            rel = ((p.grad.cpu() - want).abs().max() / want.abs().max()).item()
            checked[name] = rel
            if not rel <= GRAD_TOL:
                failures.append(("grad", name, rel))
    bad = [n for n, p in gpu_model.named_parameters() if p.requires_grad and (
        p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool((p.grad != 0).any()))]
    if bad:
        failures.append(("grad zero or non-finite", bad))
    n_trainable = sum(p.requires_grad for p in gpu_model.parameters())
    emit({"phase": "grad", "dtype": "float32", "layers": "2+2", "batch": 2, "bucket": [256, 256],
          "padded_image": [200, 176], "targets": 64, "tol": GRAD_TOL, "losses": losses,
          "grad_rel_err": checked, "max_grad_rel_err": max(checked.values()),
          "trainable": n_trainable, "zero_or_nonfinite": bad, "launches": launches})


def train_phase(rng, smi, failures):
    """The stage-2 train path: a bfloat16 Trainer at full width on the card."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.train.optimizer import clip_gradients
    from countdetr_tpu_torch.train.train_step import Trainer, prepare_stage2_batch, stage2_loss

    trainer = Trainer(stage2_config(compute_dtype="bfloat16"), TrainConfig(), device="cuda",
                      seed=0)
    model = trainer.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    batches = {700: train_batch(rng, 8, 592, 700, n_valid_first=40),
               128: train_batch(rng, 8, 592, 128)}
    plan = [700, 128] * 3

    match_ms = []
    solve = matching.batched_match

    def timed_match(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = solve(*a, **k)
        e1.record()
        match_ms.append((e0, e1))
        return out

    matching.batched_match = timed_match
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, metrics = [], []
    try:
        for T in plan:
            t = time.perf_counter()
            m = trainer.step(batches[T])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
    finally:
        matching.batched_match = solve
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_launches = {"rcda": 12 * len(plan), "rcda_rank1": 0, "mha": 6 * len(plan),
                     "auction": len(plan), "pack": 0}
    if launches != want_launches:
        failures.append(("train launches", launches, want_launches))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        failures.append(("train", "non-finite metric", metrics))
    bad_steps = int(trainer.bad_steps.item())
    if bad_steps:
        failures.append(("train", "bad_steps", bad_steps))
    after = model.state_dict()
    frozen_changed = [k for k in before if k not in trainable and not torch.equal(before[k], after[k])]
    not_moved = [k for k in trainable if torch.equal(before[k], after[k])]
    if frozen_changed or not_moved:
        failures.append(("train", "frozen changed", frozen_changed, "not moved", not_moved))

    # one step of each kind in three parts (CUDA events): forward + match +
    # loss, backward, update; then one profiled step of each kind
    parts, prof = {}, {}
    for T in (700, 128):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        b = prepare_stage2_batch(batches[T], trainer.device)
        trainer.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        total, _, _ = stage2_loss(model, b, trainer.train_cfg)
        ev[1].record()
        total.backward()
        ev[2].record()
        clip_gradients(trainer.params, trainer.train_cfg.clip_max_norm)
        trainer.optimizer.step()
        trainer.scheduler.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts[f"t{T}"] = {"forward_loss_ms": ev[0].elapsed_time(ev[1]),
                          "backward_ms": ev[1].elapsed_time(ev[2]),
                          "update_ms": ev[2].elapsed_time(ev[3]),
                          "backward_share": ev[1].elapsed_time(ev[2]) / ev[0].elapsed_time(ev[3])}
        prof[f"t{T}"] = profile_calls(lambda: trainer.step(batches[T]), 1, top=15)

    steady = step_ms[1:]
    emit({"phase": "train", "dtype": "bfloat16", "batch": 8, "bucket": [592, 592],
          "targets_per_step": plan, "step_ms": step_ms,
          "step_ms_mean_after_first": float(np.mean(steady)),
          "step_ms_mean_t700": float(np.mean([ms for ms, T in zip(step_ms, plan) if T == 700][1:])),
          "step_ms_mean_t128": float(np.mean([ms for ms, T in zip(step_ms, plan) if T == 128])),
          "train_img_per_s": 8e3 / float(np.mean(steady)),
          "match_ms": [a.elapsed_time(z) for a, z in match_ms], "metrics": metrics,
          "bad_steps": bad_steps, "launches": launches, "launches_expected": want_launches,
          "frozen_changed": frozen_changed, "not_moved": not_moved,
          "trainable_tensors": len(trainable), "peak_memory_gb": peak_gb,
          "step_parts": parts, "profile": prof, "nvidia_smi": smi})
    return launches


STAGE1_BUCKETS = ((384, 384), (384, 512), (384, 672))


def stage1_batch(rng, B, size, P, n_valid=None, pad=None):
    """A Batcher-format stage-1 batch: packed uint8 images, P points with
    their target w, h; image 0 keeps its first ``n_valid`` points, image 1
    is padded to ``pad`` (h, w) when given, its points inside the content."""
    from countdetr_tpu_torch.data.batching import pack_space_to_depth

    H, W = size
    raw = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    mask = np.zeros((B, H, W), bool)
    points = rng.uniform(0.05, 0.95, (B, P, 2)).astype(np.float32)
    if pad is not None:
        mask[1, pad[0]:, :] = True
        mask[1, :, pad[1]:] = True
        raw[mask] = 0
        points[1] *= np.asarray([pad[1] / W, pad[0] / H], np.float32)
    valid = np.ones((B, P), bool)
    if n_valid is not None:
        valid[0, n_valid:] = False
    return {"images": pack_space_to_depth(raw), "pad_mask": mask, "points": points,
            "points_valid": valid, "whs": rng.uniform(0.02, 0.3, (B, P, 2)).astype(np.float32),
            "batch_valid": np.ones(B, bool)}


def stage1_parity_phase(rng, failures):
    """Full-width float32 stage 1: card (kernels) against CPU (plain), both
    RCDA variants, the same weights; the card forward's launches counted
    (12 of the variant's RCDA counter, 0 of the other's, 6 MHA)."""
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.models.anchor_detr import build_model

    batch = stage1_batch(rng, 2, (384, 672), 700, n_valid=500, pad=(300, 500))
    keys = ("images", "pad_mask", "points", "points_valid")
    rec, launches = {}, {}
    for variant in ("v3", "rank1"):
        cfg = stage1_config(rcda_variant=variant)
        cpu_model = build_model(cfg, device="cpu", seed=0)
        perturb_(cpu_model, 3)
        gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict())
        inputs = [torch.from_numpy(batch[k]).cuda() for k in keys]
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_launches()
            out_gpu = gpu_model(*inputs)
            torch.cuda.synchronize()
            launches[variant] = launch_counts()
            out_cpu = cpu_model(*(torch.from_numpy(batch[k]) for k in keys))
        want = {"rcda": 0, "rcda_rank1": 0, "mha": 6, "auction": 0, "pack": 0}
        want["rcda" if variant == "v3" else "rcda_rank1"] = 12
        if launches[variant] != want:
            failures.append(("stage1 parity launches", variant, launches[variant], want))
        rec[variant] = {}
        for key in ("pred_logits", "pred_wh", "pred_points"):
            a, b = out_gpu[key].cpu(), out_cpu[key]
            rec[variant][key] = {"max_abs_err": (a - b).abs().max().item(),
                                 "finite": bool(torch.isfinite(a).all())}
            if not (rec[variant][key]["max_abs_err"] <= PARITY_TOL and rec[variant][key]["finite"]):
                failures.append(("stage1 parity", variant, key, rec[variant][key]))
        del cpu_model, gpu_model, out_gpu
    emit({"phase": "stage1_parity", "batch": 2, "bucket": [384, 672], "padded_image": [300, 500],
          "points": 700, "valid_points": [500, 700], "dtype": "float32", "tol": PARITY_TOL,
          "outputs": rec, "launches": launches})
    return launches


def stage1_train_phase(rng, smi, failures):
    """Stage 1's train path: a bfloat16 stage-1 Trainer at full width."""
    from countdetr_tpu_torch.config import TrainConfig, stage1_config

    from countdetr_tpu_torch.train.train_step import Trainer

    trainer = Trainer(stage1_config(compute_dtype="bfloat16"), TrainConfig(), device="cuda",
                       seed=0)
    model = trainer.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    batches = [stage1_batch(rng, 8, (384, 672), 3) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, metrics = [], []
    for i in range(6):
        t = time.perf_counter()
        m = trainer.step(batches[i % 2])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = launch_counts()
    want = {"rcda": 12 * 6, "rcda_rank1": 0, "mha": 6 * 6, "auction": 0, "pack": 0}
    if launches != want:
        failures.append(("stage1 train launches", launches, want))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        failures.append(("stage1 train", "non-finite metric", metrics))
    bad_steps = int(trainer.bad_steps.item())
    if bad_steps:
        failures.append(("stage1 train", "bad_steps", bad_steps))
    after = model.state_dict()
    frozen_changed = [k for k in before if k not in trainable and not torch.equal(before[k], after[k])]
    # the stage-1 loss does not reach the cls head: only AdamW's decay acts
    # on it, lr * wd = 1e-8 relative, below float32 resolution (as in JAX)
    not_moved = [k for k in trainable if torch.equal(before[k], after[k])
                 and not k.startswith("transformer.cls_embed")]
    if frozen_changed or not_moved:
        failures.append(("stage1 train", "frozen changed", frozen_changed, "not moved", not_moved))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_calls(lambda: trainer.step(batches[0]), 2, top=12)
    steady = step_ms[1:]
    emit({"phase": "stage1_train", "dtype": "bfloat16", "batch": 8, "bucket": [384, 672],
          "queries": 3, "step_ms": step_ms, "step_ms_mean_after_first": float(np.mean(steady)),
          "train_img_per_s": 8e3 / float(np.mean(steady)), "metrics": metrics,
          "bad_steps": bad_steps, "launches": launches, "launches_expected": want,
          "frozen_changed": frozen_changed, "not_moved": not_moved,
          "trainable_tensors": len(trainable), "peak_memory_gb": peak_gb, "profile": prof,
          "nvidia_smi": smi})
    return launches


def pseudo_dataset(rng, n=18):
    """Images of mixed sizes in the three stage-1 buckets, with point counts
    in all three tiers of max_points=700 (128, 700, 5600); image 2 holds
    3700 points, FSC-147's densest."""
    widths = ((200, 384), (385, 512), (513, 672))
    counts = ((20, 128), (129, 700), (701, 3000))
    ds = []
    for i in range(n):
        h = int(rng.integers(200, 385))
        w = int(rng.integers(*widths[i % 3]))
        k = 3700 if i == 2 else int(rng.integers(*counts[(i // 3) % 3]))
        ds.append({"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                   "points": rng.uniform(0.01, 0.99, (k, 2)).astype(np.float32),
                   "orig_size": (w, h), "image_id": 1000 + i, "image_name": f"{1000 + i}.jpg"})
    return ds


def pseudo_label_f32(ds, state, kw, n_points, n_batches, out_dir, failures):
    """The CLI's default dtype under each variant: one float32 pass of "v3",
    then of "rank1", over ``ds`` on the weights ``state``, the counters
    zeroed just before each and read after (both variants take
    csrc/rcda.cu's 3xTF32 kernel; rank-1's launches count as rank-1's):
    finite boxes, one a point, rank-1's within 1 px of v3's, and how many
    boxes differ at all."""
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.train.engine import generate_pseudo_labels

    rec, boxes = {}, {}
    for v in ("v3", "rank1"):
        model = build_model(stage1_config(rcda_variant=v), device="cuda", state_dict=state)
        path = os.path.join(out_dir, f"pseudo_f32_{v}.json")
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        generate_pseudo_labels(model, ds, path, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = launch_counts()
        del model
        want = {"rcda": 0, "rcda_rank1": 0, "mha": 6 * n_batches, "auction": 0,
                "pack": 0}
        want["rcda" if v == "v3" else "rcda_rank1"] = 12 * n_batches
        if launches != want:
            failures.append(("pseudo_label f32 launches", v, launches, want))
        with open(path) as f:
            anns = json.load(f)["annotations"]
        boxes[v] = np.asarray([x["bbox"] for x in anns], np.float64)
        if not (len(anns) == n_points and np.isfinite(boxes[v]).all()):
            failures.append(("pseudo_label f32", v, len(anns), n_points, "finite",
                             bool(np.isfinite(boxes[v]).all())))
        rec[v] = {"seconds": seconds, "launches": launches, "launches_expected": want,
                  "annotations": len(anns)}
    a, b = boxes["v3"], boxes["rank1"]
    same_layout = a.shape == b.shape and bool((a[:, :2] == b[:, :2]).all())
    wh_diff = np.abs(a[:, 2:] - b[:, 2:]) if same_layout else np.asarray([np.inf])
    if not (same_layout and wh_diff.max() <= 1):
        failures.append(("pseudo_label f32 variants disagree", float(wh_diff.max())))
    rec["wh_px_max_diff"] = float(wh_diff.max())
    rec["boxes_differing"] = int((a != b).any(1).sum()) if same_layout else None
    return rec


def pseudo_label_phase(rng, smi, failures):
    """Stage 1's main path: pseudo-labelling under both RCDA variants, in
    bfloat16 (timed and profiled) and in float32 (``pseudo_label_f32``)."""
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.train.engine import generate_pseudo_labels, point_tiers

    ds = pseudo_dataset(rng)
    n_points = sum(len(s["points"]) for s in ds)
    n_batches = len(Batcher(ds, 8, STAGE1_BUCKETS, max_points=700, point_tiers=point_tiers(700)))
    tiers = sorted({b["points"].shape[1] for b in Batcher(
        ds, 8, STAGE1_BUCKETS, max_points=700, point_tiers=point_tiers(700))})
    out_dir = tempfile.mkdtemp(prefix="pseudo_labels_")
    cpu_model = build_model(stage1_config(), device="cpu", seed=0)
    perturb_(cpu_model, 5)  # the wh head must depend on the image
    state = cpu_model.state_dict()
    kw = dict(batch_size=8, buckets=STAGE1_BUCKETS, max_points=700, pack_s2d=True)
    models = {v: build_model(stage1_config(compute_dtype="bfloat16", rcda_variant=v),
                             device="cuda", state_dict=state) for v in ("v3", "rank1")}
    paths = {v: os.path.join(out_dir, f"pseudo_{v}.json") for v in models}
    for v, model in models.items():  # warm-up, outside the counts
        generate_pseudo_labels(model, ds, paths[v], **kw)
    rec = {v: {"seconds": [], "launches": []} for v in models}
    # timed, counters zeroed just before each run and read after
    for v in ("v3", "rank1"):
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        generate_pseudo_labels(models[v], ds, paths[v], also_xywh_path=paths[v][:-5] + "_xywh.json",
                               **kw)
        torch.cuda.synchronize()
        rec[v]["seconds"].append(time.perf_counter() - t)
        rec[v]["launches"].append(launch_counts())
    jsons, launches_by_variant = {}, {}
    for v, r in rec.items():
        key = "rcda" if v == "v3" else "rcda_rank1"
        want = {"rcda": 0, "rcda_rank1": 0, "mha": 6 * n_batches, "auction": 0,
                "pack": 0}
        want[key] = 12 * n_batches
        if any(got != want for got in r["launches"]):
            failures.append(("pseudo_label launches", v, r["launches"], want))
        launches_by_variant[v] = r["launches"][0]
        with open(paths[v]) as f:
            jsons[v] = json.load(f)
        anns = jsons[v]["annotations"]
        if not (len(anns) == n_points and jsons[v]["box_format"] == "cxcywh"
                and len(jsons[v]["images"]) == len(ds)):
            failures.append(("pseudo_label", v, len(anns), n_points))
        seconds = float(np.mean(r["seconds"]))
        r.update({"launches_expected": want, "annotations": len(anns),
                  "img_per_s": len(ds) / seconds, "points_per_s": n_points / seconds,
                  "profile": profile_calls(
                      lambda: generate_pseudo_labels(models[v], ds, paths[v], **kw), 1)})
    a = np.asarray([x["bbox"] for x in jsons["v3"]["annotations"]], np.float64)
    b = np.asarray([x["bbox"] for x in jsons["rank1"]["annotations"]], np.float64)
    same_layout = a.shape == b.shape and bool((a[:, :2] == b[:, :2]).all())
    wh_diff = np.abs(a[:, 2:] - b[:, 2:]) if same_layout else np.asarray([np.inf])
    if not (same_layout and wh_diff.max() <= 1):
        failures.append(("pseudo_label variants disagree", float(wh_diff.max())))
    del models
    f32 = pseudo_label_f32(ds, state, kw, n_points, n_batches, out_dir, failures)
    launches_by_variant.update({f"f32_{v}": f32[v]["launches"] for v in ("v3", "rank1")})
    emit({"phase": "pseudo_label", "dtype": "bfloat16", "images": len(ds),
          "points": n_points, "max_points_in_an_image": max(len(s["points"]) for s in ds),
          "batch_size": 8, "batches": n_batches, "point_tiers": tiers,
          "buckets": [list(x) for x in STAGE1_BUCKETS], "variants": rec,
          "wh_px_max_diff": float(wh_diff.max()),
          "wh_px_mean_abs_diff": float(wh_diff.mean()),
          "wh_px_share_differing": float((wh_diff > 0).mean()),
          "wh_px_mean": float(a[:, 2:].mean()), "float32": f32, "nvidia_smi": smi})
    shutil.rmtree(out_dir)
    return launches_by_variant


# the engine phase's tree: 384x576 images resize into the (384, 672) bucket;
# 4-400 objects put stage-2 batches in both the 128 and the 700 box tier
ENGINE_TREE = dict(n_train=48, n_val=16, n_test=16, size=(384, 576), objects=(4, 400), seed=0)
BOX_TIERS = (128, 700, 5600)  # cli/main.py:593-597 at max_boxes 700


class HostClock:
    """Host seconds by phase of the engine's loops, from wrappers installed
    around the loops' calls (the engine itself has no timing code):
      first     the loop blocked on the prefetch queue for its first batch
                (a new Batcher's worker pool starts, then decodes);
      wait      the loop blocked on the prefetch queue for the later batches;
      produce   the prefetch thread's Batcher iterator: loading and decoding
                (in the workers), assembling and packing (overlaps the rest);
      h2d       the batch's copies to the card (a pageable copy first waits
                for the stream's queued work);
      step      Trainer.step / eval_step / the model's forward: the copies and
                the dispatch of every kernel;
      log       the metric logger (its reads of the metrics are syncs);
      other     the loop's wall time less first, wait, step and log (train and
                eval loops: the NaN guard's bad_steps read; inference loops:
                the device-to-host copy of the outputs, which waits for the
                forward, and the host post-processing and JSON)."""

    def __init__(self, engine, train_step):
        self.engine, self.ts = engine, train_step
        self.s = {}

    def _add(self, key, t0):
        self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0

    def __enter__(self):
        eng, ts, clock = self.engine, self.ts, self
        self.saved = (eng.prefetch, eng._inputs, ts.prepare_stage1_batch,
                      ts.prepare_stage2_batch, ts.Trainer.step, ts.Trainer.eval_step,
                      eng.MetricLogger)
        real_prefetch, real_inputs, p1, p2, step, eval_step, logger_cls = self.saved

        def produced(it):
            it = iter(it)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                clock._add("produce", t0)
                yield item

        def prefetch(it, depth=2):
            inner = real_prefetch(produced(it), depth)
            key = "first"
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(inner)
                except StopIteration:
                    return
                clock._add(key, t0)
                key = "wait"
                yield item

        def timed(key, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    clock._add(key, t0)
            return wrapper

        class Logger(logger_cls):
            def step(self, metrics, force=False):
                t0 = time.perf_counter()
                super().step(metrics, force)
                clock._add("log", t0)

        eng.prefetch, eng._inputs, eng.MetricLogger = prefetch, timed("h2d", real_inputs), Logger
        ts.prepare_stage1_batch, ts.prepare_stage2_batch = timed("h2d", p1), timed("h2d", p2)
        ts.Trainer.step, ts.Trainer.eval_step = timed("step", step), timed("step", eval_step)
        return self

    def __exit__(self, *exc):
        eng, ts = self.engine, self.ts
        (eng.prefetch, eng._inputs, ts.prepare_stage1_batch, ts.prepare_stage2_batch,
         ts.Trainer.step, ts.Trainer.eval_step, eng.MetricLogger) = self.saved

    def run(self, fn, forward_of=None):
        """fn() with the phases counted afresh; ``forward_of``: a model whose
        forward calls count as ``step`` (the inference loops). Returns
        (fn's result, wall seconds, seconds by phase)."""
        self.s = {}
        hooks = []
        if forward_of is not None:
            t = {}
            hooks = [forward_of.register_forward_pre_hook(
                         lambda m, a: t.__setitem__(0, time.perf_counter())),
                     forward_of.register_forward_hook(lambda m, a, o: self._add("step", t[0]))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        wall = time.perf_counter() - t0
        phases = {k: self.s.get(k, 0.0)
                  for k in ("first", "wait", "produce", "h2d", "step", "log")}
        phases["dispatch"] = phases["step"] - phases["h2d"] if forward_of is None else \
            phases["step"]
        phases["other"] = wall - sum(phases[k] for k in ("first", "wait", "step", "log")) - (
            phases["h2d"] if forward_of is not None else 0.0)
        return out, wall, phases


def flat_state(obj, prefix=""):
    """(key path, leaf) pairs of nested dicts and lists."""
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in flat_state(v, f"{prefix}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [x for i, v in enumerate(obj) for x in flat_state(v, f"{prefix}/{i}")]
    return [(prefix, obj)]


def state_mismatches(got, want):
    """Key paths where two Trainer states differ (tensors compared bit for
    bit on the host)."""
    fg, fw = flat_state(got), flat_state(want)
    if [k for k, _ in fg] != [k for k, _ in fw]:
        return ["structure"]
    bad = []
    for (k, a), (_, b) in zip(fg, fw):
        if isinstance(a, torch.Tensor):
            if not (a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())):
                bad.append(k)
        elif a != b:
            bad.append(k)
    return bad


def engine_phase(smi, failures, out_dir):
    """The training and evaluation engine on a synthetic FSCD-147 tree: the
    readers, the shuffled Batcher with 2 workers, train_one_epoch, a
    checkpoint, its restore and a resumed epoch, evaluate, infer_detections,
    counting_summary, COCO AP, and stage 1's loop and stage1_test."""
    import PIL  # the readers decode JPEGs with Pillow; its absence fails the phase

    from countdetr_tpu_torch.config import TrainConfig, stage1_config, stage2_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.data.coco_io import CocoJson
    from countdetr_tpu_torch.data.fscd147 import FSC147Pseudo, FSCD147Eval, FSCD147Exemplars
    from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
    from countdetr_tpu_torch.eval.coco_eval import CocoEvaluator
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.train import checkpoints, engine
    from countdetr_tpu_torch.train import train_step as ts

    t_phase = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="engine_")
    root, ckpt_dir = os.path.join(work, "fscd147"), os.path.join(work, "checkpoints")
    t = time.perf_counter()
    make_synthetic_fscd147(root, **ENGINE_TREE)
    tree_s = time.perf_counter() - t

    def reader(cls, split):
        ds = cls(root, split)
        ds.host_normalize = False  # the raw uint8 pipe; the model normalizes on the card
        return ds

    loader_kw = dict(max_points=700, max_boxes=700, num_workers=2, pack_s2d=True)
    train_ds = reader(FSC147Pseudo, "train")
    batcher = Batcher(train_ds, 8, STAGE1_BUCKETS, shuffle=True, seed=42, box_tiers=BOX_TIERS,
                      **loader_kw)
    steps = batcher.num_batches()
    sched = batcher._schedule()
    tiers = [key[2] for key, _, _ in sched]
    rec = {"phase": "engine", "dtype": "bfloat16", "batch": 8, "tree": ENGINE_TREE,
           "tree_s": tree_s, "jpeg_decode": True, "pillow": PIL.__version__,
           "steps_per_epoch": steps, "box_tiers_epoch0": tiers, "loops": {}}

    # the matcher's rounds a step, read after the loop (no sync inside it)
    rounds, caps = [], []
    real_assign = matching.auction_assign

    def assign_with_rounds(benefit, active, eps, max_iters, scaling=False):
        assigned, r, _ = real_assign(benefit, active, eps, max_iters, scaling, with_stats=True)
        rounds.append(r)
        caps.append(max_iters)
        return assigned

    def loop(name, fn, want, n_img, profiled=False, forward_of=None):
        """Run one loop with its launch counts, host phases, peak memory and,
        when ``profiled``, the device's idle share over it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        prof = None
        if profiled:
            (out, wall, phases), prof = profile_run(lambda: clock.run(fn, forward_of))
        else:
            out, wall, phases = clock.run(fn, forward_of)
        launches = launch_counts()
        if launches != want:
            failures.append(("engine launches", name, launches, want))
        rec["loops"][name] = {"wall_s": wall, "images": n_img, "img_per_s": n_img / wall,
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "host_s": phases, "launches": launches,
                              "launches_expected": want, "profile": prof}
        return out

    def train_want(n, variant="v3", auction=True):
        key = "rcda" if variant == "v3" else "rcda_rank1"
        w = {"rcda": 0, "rcda_rank1": 0, "mha": 6 * n, "auction": n if auction else 0,
             "pack": 0}
        w[key] = 12 * n
        return w

    matching.auction_assign = assign_with_rounds
    clock = HostClock(engine, ts)
    try:
        with clock:
            # 2. stage 2: epoch 0, a checkpoint, epoch 1; a second trainer
            # restored from the checkpoint runs epoch 1 again
            cfg2 = stage2_config(compute_dtype="bfloat16")
            trainer = ts.Trainer(cfg2, TrainConfig(), device="cuda", seed=0,
                                 steps_per_epoch=steps)
            stats0 = loop("stage2_epoch0", lambda: engine.train_one_epoch(trainer, batcher, 0),
                          train_want(steps), 48)
            # per step: each image's rounds and the step's cap (16T + 2048 when T > Q)
            rounds0 = [([int(x) for x in r.cpu()], int(c)) for r, c in zip(rounds, caps)]
            saver = checkpoints.AsyncSaver()
            snapshot = checkpoints._host_copy(trainer.state_dict())
            t = time.perf_counter()
            saver.save(ckpt_dir, 0, trainer, {"epoch": 0})
            save_return_s = time.perf_counter() - t
            saver.finalize()
            save_total_s = time.perf_counter() - t
            stats1 = loop("stage2_epoch1", lambda: engine.train_one_epoch(
                trainer, batcher, 1, log_every=1), train_want(steps), 48, profiled=True)

            resumed = ts.Trainer(cfg2, TrainConfig(), device="cuda", seed=1,
                                 steps_per_epoch=steps)
            step = checkpoints.latest_step(ckpt_dir)
            t = time.perf_counter()
            meta = checkpoints.restore_checkpoint(ckpt_dir, step, resumed)
            restore_s = time.perf_counter() - t
            mismatched = state_mismatches(resumed.state_dict(), snapshot)
            if step != 0 or meta.get("epoch") != 0 or mismatched:
                failures.append(("engine restore", step, meta.get("epoch"), mismatched[:5]))
            batcher.epoch = 1  # the resumed run sees epoch 1's schedule again
            stats_r = loop("stage2_epoch1_resumed", lambda: engine.train_one_epoch(
                resumed, batcher, 1, log_every=1), train_want(steps), 48)
            rel = abs(stats_r["loss"] - stats1["loss"]) / abs(stats1["loss"])
            if not rel <= 1e-2:
                failures.append(("engine resumed loss", stats_r["loss"], stats1["loss"]))
            batcher.close()
            if not all(np.isfinite(v) for st in (stats0, stats1, stats_r) for v in st.values()):
                failures.append(("engine non-finite stats", stats0, stats1, stats_r))
            del resumed, snapshot
            for name in ("checkpoint_0.meta.json", "latest.json"):
                shutil.copy(os.path.join(ckpt_dir, name), out_dir)
            ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "checkpoint_0",
                                                      checkpoints.PAYLOAD))
            rec["stage2"] = {
                "epochs": {"0": stats0, "1": stats1, "1_resumed": stats_r},
                "resumed_loss_rel_err": rel, "restore_bit_equal": not mismatched,
                "restored_step": step, "opt_step": meta.get("opt_step"),
                "checkpoint_bytes": ckpt_bytes, "save_return_s": save_return_s,
                "save_commit_s": save_total_s, "restore_s": restore_s,
                "auction_rounds_and_cap_epoch0": rounds0,
                "auction_images_at_cap_epoch0": sum(x >= c for r, c in rounds0 for x in r)}

            # 3. evaluation on the trained weights
            val_b = Batcher(reader(FSC147Pseudo, "val"), 8, STAGE1_BUCKETS, box_tiers=BOX_TIERS,
                            **loader_kw)
            n_val = val_b.num_batches()
            vstats = loop("evaluate", lambda: engine.evaluate(trainer, val_b),
                          train_want(n_val), 16, profiled=True)
            val_b.close()
            test_ds = reader(FSCD147Eval, "test")
            n_test = len(Batcher(test_ds, 8, STAGE1_BUCKETS, **loader_kw))
            pred_path = os.path.join(out_dir, "predictions_test.json")
            model = trainer.model
            results = loop("infer_detections", lambda: engine.infer_detections(
                model, test_ds, pred_path, batch_size=8, buckets=STAGE1_BUCKETS, **loader_kw),
                train_want(n_test, auction=False), 16, profiled=True, forward_of=model)
            counting = engine.counting_summary(results)
            gt = CocoJson(os.path.join(root, "instances_test.json"))
            ev = CocoEvaluator()
            for r in results:
                b = np.asarray(r["boxes_cxcywh_px"], np.float64).reshape(-1, 4)
                xywh = np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, 2:]], 1)
                ev.add_image(xywh, r["scores"], [a["bbox"] for a in gt.anns_for(r["image_id"])])
            t = time.perf_counter()
            ap = ev.summarize()
            ap_s = time.perf_counter() - t
            metrics = {"val": vstats, "test_counting": counting, "test_ap": ap}
            with open(os.path.join(out_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
            finite = all(np.isfinite(v) for d in (vstats, counting, ap) for v in d.values())
            if not (finite and len(results) == 16 and os.path.exists(pred_path)):
                failures.append(("engine evaluation", metrics))
            rec["evaluation"] = {**metrics, "ap_s": ap_s,
                                 "count_pred": [r["count_pred"] for r in results],
                                 "count_gt": [r["count_gt"] for r in results]}
            del trainer, model

            # 4. stage 1 under rank-1: one epoch of 6 steps, then stage1_test
            s1_b = Batcher(reader(FSCD147Exemplars, "train"), 8, STAGE1_BUCKETS, shuffle=True,
                           seed=42, **loader_kw)
            n_s1 = s1_b.num_batches()
            t1 = ts.Trainer(stage1_config(compute_dtype="bfloat16", rcda_variant="rank1"),
                            TrainConfig(), device="cuda", seed=0, steps_per_epoch=n_s1)
            s1_stats = loop("stage1_epoch0", lambda: engine.train_one_epoch(t1, s1_b, 0),
                            train_want(n_s1, "rank1", auction=False), 48, profiled=True)
            s1_b.close()
            s1_path = os.path.join(out_dir, "pseudo_test_anchor_detr_v3.json")
            loop("stage1_test", lambda: engine.stage1_test(
                t1.model, test_ds, s1_path, batch_size=8, buckets=STAGE1_BUCKETS, **loader_kw),
                train_want(n_test, "rank1", auction=False), 16, profiled=True,
                forward_of=t1.model)
            with open(s1_path) as f:
                s1_json = json.load(f)
            boxes = np.asarray([a["bbox"] for a in s1_json["annotations"]], np.float64)
            if not (n_s1 == 6 and s1_stats["steps"] == 6 and len(s1_json["images"]) == 16
                    and len(boxes) == 16 * 100 and np.isfinite(boxes).all()):
                failures.append(("engine stage 1", n_s1, s1_stats, len(boxes)))
            rec["stage1"] = {"rcda_variant": "rank1", "epoch0": s1_stats,
                             "stage1_test_annotations": len(boxes)}
            del t1
    finally:
        matching.auction_assign = real_assign
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["outputs"] = sorted(os.listdir(out_dir))
    rec["nvidia_smi"] = smi
    emit(rec)
    return {name: r["launches"] for name, r in rec["loops"].items()}


# the cli phase: the engine tree's shape, without pseudo labels (stage 1
# writes them); the CLI's flags at full width (the parser's defaults:
# ResNet-50-DC5, hidden 256, 8 heads, 6+6 layers, FFN 1024) in bfloat16
CLI_TREE = dict(ENGINE_TREE, with_pseudo=False)
CLI_FLAGS = ["--compute_dtype", "bfloat16", "--batch_size", "8", "--num_workers", "2",
             "--log_every", "1", "--device", "cuda"]
CLI_STAGE1 = ["--stage", "1", "--spatial_prior", "defined", "--num_query_pattern", "1",
              "--num_query_position", "3"]
CLI_STAGE2 = ["--stage", "2", "--spatial_prior", "grid", "--num_query_position", "600",
              "--num_query_pattern", "1", "--no_aux_loss"]
CLI_BENCH = {
    "train": ["--mode", "train", "--queries", "600", "--max_boxes", "700", "--size", "592"],
    "match": ["--mode", "match", "--iters", "3"],
    "e2e": ["--mode", "e2e", "--n_images", "32"],
    "flops": ["--mode", "flops"],
}
CLI_BENCH_DEVICE = "cuda"


def cli_phase(smi, failures, out_dir):
    """The port's command line over a synthetic FSCD-147 tree: stage-1
    train (rank-1), pseudo-labels (v3), stage-2 train, its auto-resume,
    --eval, --infer, --evaluate_predictions (a python -m subprocess),
    stage-1 --test (rank-1), a bare --stage 2 (the learned prior) trained
    and inferred from, and the bench modes. Each in-process mode runs
    with the launch counters zeroed before and read after, against 12 RCDA
    (or rank-1) and 6 MHA launches a forward and one auction launch a
    stage-2 train or eval step."""
    import contextlib
    import multiprocessing

    from countdetr_tpu_torch.cli import bench
    from countdetr_tpu_torch.cli import main as cli
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.data.fscd147 import FSC147Pseudo
    from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
    from countdetr_tpu_torch.models.anchor_detr import CountingDetr
    from countdetr_tpu_torch.train import engine

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="cli_")
    root = os.path.join(work, "fscd147")
    s1, s2 = os.path.join(work, "stage1"), os.path.join(work, "stage2")
    logs = os.path.join(out_dir, "cli")
    os.makedirs(logs, exist_ok=True)
    t = time.perf_counter()
    make_synthetic_fscd147(root, **CLI_TREE)
    rec = {"phase": "cli", "dtype": "bfloat16", "tree": CLI_TREE,
           "tree_s": time.perf_counter() - t, "modes": {}}

    forwards = [0]

    def count_forward(module, args, output):
        if isinstance(module, CountingDetr):
            forwards[0] += 1

    epochs = []  # (steps, real samples, seconds) of each train_one_epoch call
    real_epoch = engine.train_one_epoch

    def timed_epoch(*a, **k):
        t0 = time.perf_counter()
        stats = real_epoch(*a, **k)
        epochs.append((stats["steps"], stats["real_samples"], time.perf_counter() - t0))
        return stats

    def want(n, variant="v3", matching=False):
        w = {"rcda": 0, "rcda_rank1": 0, "mha": 6 * n, "auction": n if matching else 0,
             "pack": 0}
        w["rcda" if variant == "v3" else "rcda_rank1"] = 12 * n
        return w

    def run(name, call, want_of, variant="v3", out=None, images=None):
        """call() with its stdout in cli/{name}.txt, the launch counters and
        the forward count zeroed before and read after."""
        os.environ["COUNTDETR_PALLAS_VARIANT"] = variant
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forwards[0] = 0
        del epochs[:]
        t0 = time.perf_counter()
        with open(os.path.join(logs, f"{name}.txt"), "w") as f, contextlib.redirect_stdout(f):
            result = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, n = launch_counts(), forwards[0]
        expected = want_of(n)
        if launches != expected:
            failures.append(("cli launches", name, n, launches, expected))
        leftover = multiprocessing.active_children()
        if leftover:
            failures.append(("cli workers left", name, len(leftover)))
        r = {"wall_s": wall, "forwards": n, "launches": launches,
             "launches_expected": expected,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if images is not None:
            r["images"], r["img_per_s"] = images, images / wall
        if epochs:
            r["epochs"] = [{"steps": s, "real_samples": n_, "seconds": sec,
                            "img_per_s": n_ / sec} for s, n_, sec in epochs]
            r["train_img_per_s"] = sum(e[1] for e in epochs) / sum(e[2] for e in epochs)
        if out is not None:
            r["files"] = sorted(os.listdir(out))
        rec["modes"][name] = r
        return result

    def cli_run(name, out, argv, matching=False, variant="v3", images=None):
        args = cli.get_args_parser().parse_args(
            ["--data_path", root, "--output_dir", out] + CLI_FLAGS + argv)
        return run(name, lambda: cli.main(args), lambda n: want(n, variant, matching),
                   variant, out, images)

    def read_log(out):
        with open(os.path.join(out, "log.txt")) as f:
            lines = [json.loads(x) for x in f]
        if not all(np.isfinite(v) for x in lines for v in x.values() if isinstance(v, float)):
            failures.append(("cli non-finite log", out, lines))
        return lines

    def split_images(split):
        with open(os.path.join(root, "Train_Test_Val_FSC_147.json")) as f:
            return json.load(f)[split]

    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    engine.train_one_epoch = timed_epoch
    try:
        # 1. stage-1 train, one epoch of 6 steps (and its val losses), rank-1
        t1 = cli_run("stage1_train", s1, CLI_STAGE1 + ["--epochs", "1", "--max_steps", "6"],
                     variant="rank1")
        lines = read_log(s1)
        if not (t1.scheduler.last_epoch == 6 and [x["epoch"] for x in lines] == [0]):
            failures.append(("cli stage-1 train", t1.scheduler.last_epoch, lines))
        del t1

        # 2. pseudo-labels into the tree, one box a dot
        ann = os.path.join(root, "annotations")
        cli_run("generate_pseudo_label", ann, CLI_STAGE1 + [
            "--generate_pseudo_label", "--resume", os.path.join(s1, "checkpoints")],
            images=sum(len(split_images(s)) for s in ("train", "val", "test")))
        with open(os.path.join(root, "annotation_FSC147_384.json")) as f:
            dots = json.load(f)
        pseudo = {}
        for split in ("train", "val", "test"):
            with open(os.path.join(ann, f"pseudo_bbox_{split}.json")) as f:
                p = json.load(f)
            per_image = {}
            for a in p["annotations"]:
                per_image[a["image_id"]] = per_image.get(a["image_id"], 0) + 1
            want_counts = {im["id"]: len(dots[im["file_name"]]["points"]) for im in p["images"]}
            pseudo[split] = {"images": len(p["images"]), "annotations": len(p["annotations"]),
                             "dots": sum(want_counts.values())}
            if per_image != want_counts or len(p["images"]) != len(split_images(split)):
                failures.append(("cli pseudo counts", split, pseudo[split]))
        rec["pseudo_labels"] = pseudo

        # 3. stage 2: two epochs, the second cut by --max_steps, then the
        # same output directory with --auto_resume for a third epoch
        spe = Batcher(FSC147Pseudo(root, "train"), 8, STAGE1_BUCKETS, max_boxes=700,
                      box_tiers=BOX_TIERS).num_batches()
        max_steps = spe + min(3, spe - 1)
        t2 = cli_run("stage2_train", s2, CLI_STAGE2 + [
            "--epochs", "2", "--max_steps", str(max_steps)], matching=True)
        lines = read_log(s2)
        if not (t2.scheduler.last_epoch == max_steps and [x["epoch"] for x in lines] == [0, 1]):
            failures.append(("cli stage-2 train", t2.scheduler.last_epoch, max_steps, lines))
        del t2
        t3 = cli_run("stage2_auto_resume", s2, CLI_STAGE2 + ["--epochs", "3", "--auto_resume"],
                     matching=True)
        with open(os.path.join(logs, "stage2_auto_resume.txt")) as f:
            resumed_line = next((x.strip() for x in f if x.startswith("auto-resumed")), None)
        lines = read_log(s2)
        ok = (resumed_line == f"auto-resumed: continuing at epoch 2, optimizer step {max_steps}"
              and t3.scheduler.last_epoch == max_steps + spe
              and [x["epoch"] for x in lines] == [0, 1, 2])
        if not ok:
            failures.append(("cli auto-resume", resumed_line, t3.scheduler.last_epoch, lines))
        rec["stage2"] = {"steps_per_epoch": spe, "max_steps": max_steps,
                         "resumed": resumed_line, "opt_step_after": t3.scheduler.last_epoch,
                         "log": lines}
        del t3
        ckpt_dir = os.path.join(s2, "checkpoints")

        # 4. --eval, 5. --infer, then the offline evaluator as a subprocess
        vstats = cli_run("eval", s2, CLI_STAGE2 + ["--eval", "--checkpoint_path", ckpt_dir],
                         matching=True, images=len(split_images("val")))
        if not (vstats and all(np.isfinite(v) for v in vstats.values())):
            failures.append(("cli eval", vstats))
        metrics = cli_run("infer", s2, CLI_STAGE2 + ["--infer", "--checkpoint_path", ckpt_dir],
                          images=len(split_images("val")) + len(split_images("test")))
        if not all(np.isfinite(v) for m in metrics.values() for v in m.values()):
            failures.append(("cli infer", metrics))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "countdetr_tpu_torch.cli.main", "--data_path", root,
             "--output_dir", s2, "--evaluate_predictions",
             os.path.join(s2, "predictions_test.json"), "--eval_split", "test"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        sub = {"returncode": proc.returncode, "wall_s": time.perf_counter() - t}
        with open(os.path.join(logs, "evaluate_predictions.txt"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        offline = (json.loads(proc.stdout[proc.stdout.index("{"):])
                   if proc.returncode == 0 else {})
        counting = ("MAE", "RMSE", "NAE", "MRE", "SRE", "images")
        sub["counting_equal"] = bool(offline) and all(
            offline[k] == metrics["test"][k] for k in counting)
        # AP of the file's int() pixel boxes against metrics.json's, of the
        # float boxes (the JAX CLI's two numbers differ the same way)
        sub["ap_equal"] = bool(offline) and all(
            offline[k] == v for k, v in metrics["test"].items() if k not in counting)
        sub["offline"] = offline
        # the subprocess prints what the evaluator computes here on that file
        sub["equals_in_process"] = offline == json.loads(json.dumps(
            cli.offline_eval.evaluate_predictions(os.path.join(s2, "predictions_test.json"),
                                                  root, split="test")))
        if not (sub["counting_equal"] and sub["equals_in_process"]):
            failures.append(("cli evaluate_predictions", sub, proc.stderr[-2000:]))
        rec["modes"]["evaluate_predictions"] = sub
        rec["metrics"] = metrics

        # 6. stage-1 --test from the stage-1 checkpoint, rank-1
        cli_run("stage1_test", s1, CLI_STAGE1 + [
            "--test", "--checkpoint_path", os.path.join(s1, "checkpoints")], variant="rank1",
            images=len(split_images("test")))
        with open(os.path.join(s1, "pseudo_test_anchor_detr_v3.json")) as f:
            s1_test = json.load(f)
        boxes = np.asarray([a["bbox"] for a in s1_test["annotations"]], np.float64)
        if not (len(s1_test["images"]) == len(split_images("test"))
                and len(boxes) == 100 * len(s1_test["images"]) and np.isfinite(boxes).all()):
            failures.append(("cli stage-1 test", len(s1_test["images"]), len(boxes)))

        # 7. the JAX CLI's bare --stage 2 (the learned prior, 300 x 3 = 900
        # queries): three steps, then --infer from that checkpoint
        s3 = os.path.join(work, "stage2_default")
        t4 = cli_run("stage2_default_train", s3, ["--stage", "2", "--epochs", "1",
                                                  "--max_steps", "3"], matching=True)
        lines = read_log(s3)
        if not (t4.cfg.spatial_prior == "learned" and t4.cfg.num_queries == 900
                and t4.scheduler.last_epoch == 3 and len(lines) == 1):
            failures.append(("cli bare stage 2", t4.cfg.spatial_prior, t4.cfg.num_queries,
                             t4.scheduler.last_epoch, lines))
        rec["stage2_default"] = {"queries": t4.cfg.num_queries, "log": lines}
        del t4
        m4 = cli_run("stage2_default_infer", s3, [
            "--stage", "2", "--infer", "--checkpoint_path", os.path.join(s3, "checkpoints")],
            images=len(split_images("val")) + len(split_images("test")))
        if not all(np.isfinite(v) for m in m4.values() for v in m.values()):
            failures.append(("cli bare stage 2 infer", m4))
        rec["stage2_default"]["metrics"] = m4

        for src, name in ((s1, "log.txt"), (s2, "log.txt"), (s2, "metrics.json"),
                          (s2, "eval.json")):
            shutil.copy(os.path.join(src, name),
                        os.path.join(logs, f"{os.path.basename(src)}_{name}"))

        # 8. the bench modes
        rec["bench"] = {}
        for mode, argv in CLI_BENCH.items():
            args = bench.get_args_parser().parse_args(argv + ["--device", CLI_BENCH_DEVICE])
            iters = args.iters  # match: 3 cost structures, a warm-up and iters timed each
            want_of = {
                "train": lambda n: want(n, matching=True),
                "e2e": lambda n: want(n, matching=True),
                "match": lambda n: {"rcda": 0, "rcda_rank1": 0, "mha": 0,
                                    "auction": 3 * (iters + 1), "pack": 0},
                "flops": lambda n: want(0),  # counted on the CPU, plain path
            }[mode]
            line = run(f"bench_{mode}", lambda: bench.main(args), want_of)
            rec["bench"][mode] = line
            keys = {"train": "img_per_s_per_chip", "e2e": "img_per_s_e2e",
                    "match": "cuda_detr_ms", "flops": "gflops_per_image"}[mode]
            if not (keys in line and np.isfinite(line[keys]) and line[keys] > 0):
                failures.append(("cli bench", mode, line))
    finally:
        hook.remove()
        engine.train_one_epoch = real_epoch
        os.environ.pop("COUNTDETR_PALLAS_VARIANT", None)
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["nvidia_smi"] = smi
    emit(rec)
    return {name: r["launches"] for name, r in rec["modes"].items() if "launches" in r}


# the JAX CLI's bare --stage 2 (countdetr_tpu/cli/main.py:208-230): the
# learned prior, 300 positions x 3 patterns = 900 queries
DEFAULTS = dict(spatial_prior="learned", num_query_position=300, num_query_pattern=3)
N_SAMPLED = 300  # --num_sample_points' default
# the defaults phase: bucket side, serving batch, training batch
DEFAULTS_SIZE, DEFAULTS_SERVE_BATCH, DEFAULTS_TRAIN_BATCH = 592, 32, 8


def sampled_points(rng, B, S=N_SAMPLED):
    return (rng.uniform(0.02, 0.98, (B, S, 2)).astype(np.float32), np.ones((B, S), bool))


def defaults_phase(rng, smi, failures):
    """The JAX CLI's default model options at full width: float32 card-vs-CPU
    parity of the forward under the learned and sampled priors with the
    auxiliary outputs; serving under the learned prior (3 batches of 32 at
    592x592, bfloat16); 6 bfloat16 train steps with aux_loss and dropout 0.1
    (one auction launch per decoder layer a step), then 3 under the sampled
    prior with 300 points. Returns each path's launches."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.serve import Predictor, pack_requests
    from countdetr_tpu_torch.train.train_step import Trainer

    t_phase = time.perf_counter()
    S, SB, TB = DEFAULTS_SIZE, DEFAULTS_SERVE_BATCH, DEFAULTS_TRAIN_BATCH
    rec = {"phase": "defaults", "model": DEFAULTS, "queries": 900}
    paths = {}

    # 1. float32 parity, card (kernels) against CPU (plain), aux outputs too
    padded = (S * 430 // 592, S * 511 // 592)
    images, masks, rects, _ = pack_requests(make_packed_batch(rng, [(S, S), padded]), (S, S))
    pts, pts_valid = sampled_points(rng, 2)
    pts_valid[1, 250:] = False  # 50 padded points in image 1
    rec["parity"] = {"batch": 2, "bucket": [S, S], "padded_image": list(padded),
                     "dtype": "float32", "tol": PARITY_TOL}
    for prior in ("learned", "sampled"):
        cfg = stage2_config(**dict(DEFAULTS, spatial_prior=prior), aux_loss=True)
        cpu_model = build_model(cfg, device="cpu", seed=0)
        perturb_(cpu_model, 7)  # the zero-initialised box head must depend on the input
        gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict())
        arrays = (images, masks, rects) + ((pts, pts_valid) if prior == "sampled" else ())
        with torch.inference_mode():
            out_gpu = gpu_model(*(torch.from_numpy(a).cuda() for a in arrays))
            out_cpu = cpu_model(*(torch.from_numpy(a) for a in arrays))
        errs = {}
        for key in ("pred_logits", "pred_boxes", "pred_vars"):
            errs[key] = (out_gpu[key].cpu() - out_cpu[key]).abs().max().item()
        for i, (ag, ac) in enumerate(zip(out_gpu["aux_outputs"], out_cpu["aux_outputs"])):
            for key in ("pred_logits", "pred_boxes"):
                errs[f"aux{i}_{key}"] = (ag[key].cpu() - ac[key]).abs().max().item()
        finite = all(bool(torch.isfinite(v).all()) for k, v in out_gpu.items()
                     if k != "aux_outputs")
        queries = out_gpu["pred_logits"].shape[1]
        rec["parity"][prior] = {"max_abs_err": errs, "finite": finite, "queries": queries,
                                "aux_outputs": len(out_gpu["aux_outputs"])}
        if not (max(errs.values()) <= PARITY_TOL and finite and queries == 900
                and len(out_gpu["aux_outputs"]) == cfg.dec_layers - 1):
            failures.append(("defaults parity", prior, rec["parity"][prior]))
        del cpu_model, gpu_model, out_gpu

    # 2. serving the learned prior: 3 batches of 32 at 592x592
    pred = Predictor(stage2_config(**DEFAULTS, compute_dtype="bfloat16"), device="cuda",
                     bucket=(S, S), seed=0)
    batches = [make_packed_batch(rng, [(S, S)] * SB) for _ in range(3)]
    pred.predict(batches[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    reset_launches()
    predict_ms, counts = [], []
    for reqs in batches:
        t = time.perf_counter()
        results = pred.predict(reqs)
        predict_ms.append((time.perf_counter() - t) * 1e3)
        counts.append([r["count"] for r in results])
        if not all(np.isfinite(r["scores"]).all() and np.isfinite(r["boxes_cxcywh_px"]).all()
                   for r in results):
            failures.append(("defaults serving", "non-finite output"))
    paths["serving"] = launch_counts()
    want = {"rcda": 12 * 3, "rcda_rank1": 0, "mha": 6 * 3, "auction": 0, "pack": 3}
    if paths["serving"] != want:
        failures.append(("defaults serving launches", paths["serving"], want))
    images, masks, rects, _ = pack_requests(batches[0], (S, S))
    dev_in = [torch.from_numpy(a).cuda() for a in (images, masks, rects)]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.model(*dev_in), 5, warmup=1)
        prof = profile_calls(lambda: pred.model(*dev_in), 2)
    rec["serving"] = {"dtype": "bfloat16", "batches": 3, "batch_size": SB, "bucket": [S, S],
                      "predict_ms": predict_ms, "counts_first_batch": counts[0][:8],
                      "launches": paths["serving"], "launches_expected": want,
                      "forward_ms": fwd_ms, "img_per_s": SB * 1e3 / fwd_ms,
                      "profile": prof}
    del pred, dev_in

    # 3. training: aux_loss and dropout under the learned prior, then the
    # sampled prior; matcher time from CUDA events around each call
    match_ev = []
    solve = matching.batched_match

    def timed_match(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = solve(*a, **k)
        e1.record()
        match_ev.append((e0, e1))
        return out

    train_batches = {700: train_batch(rng, TB, S, 700, n_valid_first=40),
                     128: train_batch(rng, TB, S, 128)}
    runs = {"train_learned": (dict(DEFAULTS, aux_loss=True, dropout=0.1), 6),
            "train_sampled": (dict(DEFAULTS, spatial_prior="sampled"), 3)}
    for name, (kw, n_steps) in runs.items():
        cfg = stage2_config(compute_dtype="bfloat16", **kw)
        trainer = Trainer(cfg, TrainConfig(), device="cuda", seed=0)
        before = {k: v.detach().clone() for k, v in trainer.model.named_parameters()
                  if v.requires_grad}
        plan = [(700, 128)[i % 2] for i in range(n_steps)]
        if cfg.spatial_prior == "sampled":
            for b in train_batches.values():
                b["sampled_points"], b["sampled_points_valid"] = sampled_points(rng, TB)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        del match_ev[:]
        step_ms, metrics = [], []
        matching.batched_match = timed_match
        try:
            for T in plan:
                t = time.perf_counter()
                m = trainer.step(train_batches[T])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                metrics.append({k: v.item() for k, v in m.items()})
        finally:
            matching.batched_match = solve
        paths[name] = launch_counts()
        per_step = cfg.dec_layers if cfg.aux_loss else 1  # one matching per output
        want = {"rcda": 12 * n_steps, "rcda_rank1": 0, "mha": 6 * n_steps,
                "auction": per_step * n_steps, "pack": 0}
        if paths[name] != want:
            failures.append((f"defaults {name} launches", paths[name], want))
        if not all(np.isfinite(v) for m in metrics for v in m.values()):
            failures.append((f"defaults {name}", "non-finite metric", metrics))
        if int(trainer.bad_steps.item()):
            failures.append((f"defaults {name}", "bad_steps", int(trainer.bad_steps.item())))
        not_moved = [k for k, p in trainer.model.named_parameters()
                     if p.requires_grad and torch.equal(before[k], p.detach())]
        if not_moved:
            failures.append((f"defaults {name}", "not moved", not_moved))
        match_ms = [a.elapsed_time(z) for a, z in match_ev]
        steady = step_ms[1:]
        rec[name] = {
            "dtype": "bfloat16", "batch": TB, "bucket": [S, S], "aux_loss": cfg.aux_loss,
            "dropout": cfg.dropout, "targets_per_step": plan, "step_ms": step_ms,
            "step_ms_mean_after_first": float(np.mean(steady)),
            "train_img_per_s": TB * 1e3 / float(np.mean(steady)),
            "match_ms": match_ms, "match_calls_per_step": per_step,
            "match_ms_per_step": [sum(match_ms[i * per_step:(i + 1) * per_step])
                                  for i in range(n_steps)],
            "aux_parts": sorted(k for k in metrics[0] if k[-2:-1] == "_" and k[-1].isdigit()),
            "losses": [m["loss"] for m in metrics], "launches": paths[name],
            "launches_expected": want, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "not_moved": not_moved,
        }
        if name == "train_learned":
            rec[name]["profile"] = profile_calls(lambda: trainer.step(train_batches[700]), 1,
                                                 top=15)
        del trainer
    for b in train_batches.values():
        b.pop("sampled_points", None), b.pop("sampled_points_valid", None)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["nvidia_smi"] = smi
    emit(rec)
    return paths


# the longtail phase: AnchorDETR's remaining model options at full width
# (ResNet-50-DC5, 6+6 layers, hidden 256, 8 heads): A, standard attention in
# stage 2 (576 grid queries); B, three feature levels in stage 1; C, the
# mask head in stage 2
LONGTAIL = {"A": dict(attention_type="MHA"), "B": dict(num_feature_levels=3),
            "C": dict(masks=True)}
# the MHA core at the shapes A and B give it: (B, L, S, key grid of image 0
# (H, W, valid h, valid w)): A's encoder over 37x37 keys and its decoder's
# cross-attention at serving B=32; B's level layer, B*H*W pixels of 3
# levels, at B=8 in the 384x672 bucket (8064) and past gridDim.z's 65535
LONGTAIL_MHA = ((32, 1369, 1369, (37, 37, 30, 25)), (32, 576, 1369, (37, 37, 30, 25)),
                (8064, 3, 3, None), (70000, 3, 3, None))
LONGTAIL_PER_FORWARD = {"A": {"mha": 18}, "B": {"rcda": 9, "mha": 9}, "C": {"rcda": 12, "mha": 6}}
LONGTAIL_TREE = dict(ENGINE_TREE, n_train=16, n_val=8, n_test=8)
# bucket side (A, C), stage 1's bucket (B), its padded image, serving and
# training batches
LONGTAIL_SIZE, LONGTAIL_S1, LONGTAIL_S1_PAD = 592, (384, 672), (300, 500)
LONGTAIL_SERVE_BATCH, LONGTAIL_TRAIN_BATCH = 32, 8
# the CLI runs: (config, flags, the inference mode)
LONGTAIL_CLI = {"mha": ("A", CLI_STAGE2 + ["--attention_type", "nn.MultiheadAttention"],
                        "--infer"),
                "levels": ("B", CLI_STAGE1 + ["--num_feature_levels", "3"], "--test"),
                "masks": ("C", CLI_STAGE2 + ["--masks"], "--infer")}


def longtail_phase(g, smi, failures, out_dir):
    """AnchorDETR's remaining model options at full width: the MHA kernel
    at the shapes they give it, float32 card-vs-CPU parity, serving,
    training, pseudo-labels, the mask head's serving and the CLI. Returns
    (each path's launches, the bfloat16 MHA cases)."""
    import contextlib

    from countdetr_tpu_torch.cli import main as cli
    from countdetr_tpu_torch.config import TrainConfig, stage1_config, stage2_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
    from countdetr_tpu_torch.models.anchor_detr import CountingDetr, build_model
    from countdetr_tpu_torch.ops.kernels import mha_kernel
    from countdetr_tpu_torch.serve import Predictor, pack_requests
    from countdetr_tpu_torch.train.engine import generate_pseudo_labels, point_tiers
    from countdetr_tpu_torch.train.train_step import Trainer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    rec = {"phase": "longtail", "configs": LONGTAIL}
    paths = {}

    def want(per_forward, n, auction=0, predict_calls=0):
        w = {"rcda": 0, "rcda_rank1": 0, "mha": 0, "auction": auction, "pack": predict_calls}
        w.update({k: v * n for k, v in per_forward.items()})
        return w

    def check_launches(path, expected):
        paths[path] = launch_counts()
        if paths[path] != expected:
            failures.append(("longtail launches", path, paths[path], expected))
        return {"launches": paths[path], "launches_expected": expected}

    # 1. the MHA kernel against its plain version at the new shapes
    t = time.perf_counter()
    rec["mha"] = [mha_case(mha_kernel, g, dt, B=B, L=L, S=S, key_grid=grid)
                  for B, L, S, grid in LONGTAIL_MHA for dt in (torch.bfloat16, torch.float32)]
    rec["mha_s"] = time.perf_counter() - t
    for c in rec["mha"]:
        if not (in_tol(c) and c["finite"] and c["dead_row_finite"] and c["dead_row_within_tol"]):
            failures.append(("longtail mha", c["shape"], c["dtype"], c["max_abs_err"]))

    # 2. float32 parity, card (kernels) against CPU (plain), one padded image
    def parity(name, cfg, arrays, keys, seed):
        cpu_model = build_model(cfg, device="cpu", seed=0)
        perturb_(cpu_model, seed)  # the zero-initialised box head must depend on the input
        gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict())
        with torch.inference_mode():
            og = gpu_model(*(torch.from_numpy(a).cuda() for a in arrays))
            oc = cpu_model(*(torch.from_numpy(a) for a in arrays))
        errs = {k: (og[k].cpu() - oc[k]).abs().max().item() for k in keys}
        finite = all(bool(torch.isfinite(og[k]).all()) for k in keys)
        r = {"max_abs_err": errs, "finite": finite,
             "shapes": {k: list(og[k].shape) for k in keys}}
        if not (max(errs.values()) <= PARITY_TOL and finite):
            failures.append(("longtail parity", name, r))
        return r

    t = time.perf_counter()
    rec["parity"] = {"dtype": "float32", "tol": PARITY_TOL}
    s2_keys = ("pred_logits", "pred_boxes", "pred_vars")
    S, S1, SB, TB = LONGTAIL_SIZE, LONGTAIL_S1, LONGTAIL_SERVE_BATCH, LONGTAIL_TRAIN_BATCH
    padded = (S * 430 // 592, S * 511 // 592)
    arrays = pack_requests(make_packed_batch(rng, [(S, S), padded]), (S, S))[:3]
    rec["parity"]["A"] = parity("A", stage2_config(**LONGTAIL["A"]), arrays, s2_keys, 11)
    b1 = stage1_batch(rng, 2, S1, 700, n_valid=500, pad=LONGTAIL_S1_PAD)
    arrays = tuple(b1[k] for k in ("images", "pad_mask", "points", "points_valid"))
    for v in ("v3", "rank1"):
        rec["parity"][f"B_{v}"] = parity(f"B {v}", stage1_config(**LONGTAIL["B"], rcda_variant=v),
                                         arrays, ("pred_logits", "pred_wh", "pred_points"), 12)
    arrays = pack_requests(make_packed_batch(rng, [padded]), (S, S))[:3]
    rec["parity"]["C"] = parity("C", stage2_config(**LONGTAIL["C"]), arrays,
                                s2_keys + ("pred_masks",), 13)
    rec["parity"]["batches"] = {"A": [[S, S], list(padded)],
                                "B": [list(S1), list(LONGTAIL_S1_PAD)], "B_points": [500, 700],
                                "C": [[S, S], list(padded)]}
    rec["parity_s"] = time.perf_counter() - t

    # 3. serving A: 3 batches of 32 at 592x592
    pred = Predictor(stage2_config(**LONGTAIL["A"], compute_dtype="bfloat16"), device="cuda",
                     bucket=(S, S), seed=0)
    batches = [make_packed_batch(rng, [(S, S)] * SB) for _ in range(3)]
    pred.predict(batches[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    results = [r for reqs in batches for r in pred.predict(reqs)]
    wall = time.perf_counter() - t
    rec["serving_A"] = check_launches("serving_A",
                                      want(LONGTAIL_PER_FORWARD["A"], 3, predict_calls=3))
    if not all(np.isfinite(r["scores"]).all() and np.isfinite(r["boxes_cxcywh_px"]).all()
               for r in results):
        failures.append(("longtail serving A", "non-finite output"))
    images, masks, rects, _ = pack_requests(batches[0], (S, S))
    dev_in = [torch.from_numpy(a).cuda() for a in (images, masks, rects)]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.model(*dev_in), 5, warmup=1)
        prof = profile_calls(lambda: pred.model(*dev_in), 2)
    rec["serving_A"].update({"dtype": "bfloat16", "batches": 3, "batch_size": SB,
                             "bucket": [S, S], "predict_img_per_s": 3 * SB / wall,
                             "forward_ms": fwd_ms, "img_per_s": SB * 1e3 / fwd_ms,
                             "device_idle_share": prof["device_idle_share"], "profile": prof})
    del pred, dev_in

    # 4. training A (B=8 at 592x592, T=700 and T=128 alternating) and B (B=8
    # in the 384x672 bucket, the 3 exemplar centres as queries)
    train_runs = {
        "A": (stage2_config(**LONGTAIL["A"], compute_dtype="bfloat16"),
              {700: train_batch(rng, TB, S, 700, n_valid_first=40),
               128: train_batch(rng, TB, S, 128)}, [700, 128] * 3),
        "B": (stage1_config(**LONGTAIL["B"], compute_dtype="bfloat16"),
              dict(enumerate(stage1_batch(rng, TB, S1, 3) for _ in range(2))), [0, 1] * 3),
    }
    for name, (cfg, tb, plan) in train_runs.items():
        trainer = Trainer(cfg, TrainConfig(), device="cuda", seed=0)
        before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
                  if p.requires_grad}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        step_ms, losses = [], []
        for key in plan:
            t = time.perf_counter()
            m = trainer.step(tb[key])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append({k: v.item() for k, v in m.items()})
        r = check_launches(f"train_{name}", want(LONGTAIL_PER_FORWARD[name], len(plan),
                                                 len(plan) if cfg.stage == 2 else 0))
        if not all(np.isfinite(v) for m in losses for v in m.values()) or \
                int(trainer.bad_steps.item()):
            failures.append(("longtail train", name, "non-finite", losses))
        # stage 1's loss does not reach the cls head (only the decay moves
        # it, below float32 resolution)
        not_moved = [k for k, p in trainer.model.named_parameters() if p.requires_grad
                     and torch.equal(before[k], p.detach())
                     and not (cfg.stage == 1 and k.startswith("transformer.cls_embed"))]
        if not_moved:
            failures.append(("longtail train", name, "not moved", not_moved))
        steady = step_ms[1:]
        prof = profile_calls(lambda: trainer.step(tb[plan[0]]), 1, top=12)
        r.update({"dtype": "bfloat16", "batch": TB, "step_ms": step_ms,
                  "step_ms_mean_after_first": float(np.mean(steady)),
                  "train_img_per_s": TB * 1e3 / float(np.mean(steady)),
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "losses": [m["loss"] for m in losses], "not_moved": not_moved,
                  "device_idle_share": prof["device_idle_share"], "profile": prof})
        rec[f"train_{name}"] = r
        del trainer

    # 5. pseudo-labels under B, "v3" then "rank1", boxes within 1 px
    ds = pseudo_dataset(rng, n=8)
    kw = dict(batch_size=8, buckets=STAGE1_BUCKETS, max_points=700, pack_s2d=True)
    n_batches = len(Batcher(ds, 8, STAGE1_BUCKETS, max_points=700, point_tiers=point_tiers(700)))
    cpu_model = build_model(stage1_config(**LONGTAIL["B"]), device="cpu", seed=0)
    perturb_(cpu_model, 14)  # the wh head must depend on the image
    state = cpu_model.state_dict()
    out_tmp = tempfile.mkdtemp(prefix="longtail_pseudo_")
    boxes, rec["pseudo_B"] = {}, {"images": len(ds), "batches": n_batches}
    for v in ("v3", "rank1"):
        model = build_model(stage1_config(**LONGTAIL["B"], compute_dtype="bfloat16",
                                          rcda_variant=v), device="cuda", state_dict=state)
        path = os.path.join(out_tmp, f"pseudo_{v}.json")
        generate_pseudo_labels(model, ds, path, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        generate_pseudo_labels(model, ds, path, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        per = dict(LONGTAIL_PER_FORWARD["B"])
        if v == "rank1":
            per["rcda_rank1"] = per.pop("rcda")
        r = check_launches(f"pseudo_B_{v}", want(per, n_batches))
        with open(path) as f:
            boxes[v] = np.asarray([a["bbox"] for a in json.load(f)["annotations"]], np.float64)
        r.update({"seconds": seconds, "img_per_s": len(ds) / seconds,
                  "annotations": len(boxes[v])})
        rec["pseudo_B"][v] = r
        del model
    shutil.rmtree(out_tmp)
    a, b = boxes["v3"], boxes["rank1"]
    same = a.shape == b.shape and len(a) == sum(len(s["points"]) for s in ds) \
        and bool((a[:, :2] == b[:, :2]).all())
    diff = float(np.abs(a[:, 2:] - b[:, 2:]).max()) if same else float("inf")
    rec["pseudo_B"]["wh_px_max_diff"] = diff
    if not diff <= 1:
        failures.append(("longtail pseudo-labels", "variants disagree", diff))

    # 6. the mask head served, C: B=2 at 592x592
    pred = Predictor(stage2_config(**LONGTAIL["C"], compute_dtype="bfloat16"), device="cuda",
                     bucket=(S, S), seed=0)
    reqs = make_packed_batch(rng, [(S, S), padded])
    pred.predict(reqs)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    results = pred.predict(reqs)
    r = check_launches("serving_C", want(LONGTAIL_PER_FORWARD["C"], 1, predict_calls=1))
    if not all(np.isfinite(x["scores"]).all() for x in results):
        failures.append(("longtail mask serving", "non-finite scores"))
    images, masks, rects, _ = pack_requests(reqs, (S, S))
    dev_in = [torch.from_numpy(x).cuda() for x in (images, masks, rects)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        out = pred.model(*dev_in)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        fwd_ms = cuda_ms(lambda: pred.model(*dev_in), 3, warmup=1)
        bare_ms = cuda_ms(lambda: pred.model(*dev_in, masks=False), 3, warmup=1)
    pm = out["pred_masks"]
    want_shape = [2, stage2_config().num_queries, -(-S // 4), -(-S // 4)]
    if list(pm.shape) != want_shape or not bool(torch.isfinite(pm).all()):
        failures.append(("longtail mask serving", list(pm.shape)))
    r.update({"dtype": "bfloat16 (the mask head float32)", "batch": 2,
              "pred_masks_shape": list(pm.shape),
              "forward_ms": fwd_ms, "forward_ms_without_mask_head": bare_ms,
              "peak_memory_gb": peak / 1e9, "peak_over_weights_gb": (peak - base) / 1e9})
    rec["serving_C"] = r
    del pred, dev_in, out, pm

    # 7. the command line: each flag value trains 2 steps, then infers (stage
    # 1: --test) from that checkpoint
    t_cli = time.perf_counter()
    work = tempfile.mkdtemp(prefix="longtail_cli_")
    root = os.path.join(work, "fscd147")
    logs = os.path.join(out_dir, "longtail")
    os.makedirs(logs, exist_ok=True)
    make_synthetic_fscd147(root, **LONGTAIL_TREE)
    forwards = [0]

    def count_forward(module, args, output):
        if isinstance(module, CountingDetr):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    os.environ["COUNTDETR_PALLAS_VARIANT"] = "v3"
    rec["cli"] = {"tree": LONGTAIL_TREE}
    try:
        for name, (config, argv, infer) in LONGTAIL_CLI.items():
            out = os.path.join(work, name)
            for mode in ("train", infer):
                extra = (["--epochs", "1", "--max_steps", "2"] if mode == "train" else
                         [mode, "--checkpoint_path", os.path.join(out, "checkpoints")])
                args = cli.get_args_parser().parse_args(
                    ["--data_path", root, "--output_dir", out] + CLI_FLAGS + argv + extra)
                torch.cuda.synchronize()
                reset_launches()
                forwards[0] = 0
                t = time.perf_counter()
                log = os.path.join(logs, f"{name}_{mode.strip('-')}.txt")
                with open(log, "w") as f, contextlib.redirect_stdout(f):
                    result = cli.main(args)
                torch.cuda.synchronize()
                n = forwards[0]
                matching = mode == "train" and config != "B"
                r = check_launches(f"cli_{name}_{mode.strip('-')}",
                                   want(LONGTAIL_PER_FORWARD[config], n, n if matching else 0))
                r.update({"wall_s": time.perf_counter() - t, "forwards": n,
                          "files": sorted(os.listdir(out))})
                if mode == "train":
                    with open(os.path.join(out, "log.txt")) as f:
                        lines = [json.loads(x) for x in f]
                    ok = (result.scheduler.last_epoch == 2 and len(lines) == 1 and all(
                        np.isfinite(v) for v in lines[0].values() if isinstance(v, float)))
                    r["loss"] = lines[0].get("loss") if lines else None
                elif infer == "--infer":
                    ok = all(np.isfinite(v) for m in result.values() for v in m.values())
                    r["metrics_test"] = result["test"]
                else:
                    ok = os.path.exists(os.path.join(out, "pseudo_test_anchor_detr_v3.json"))
                if not ok:
                    failures.append(("longtail cli", name, mode, r))
                rec["cli"][f"{name}_{mode.strip('-')}"] = r
    finally:
        hook.remove()
        os.environ.pop("COUNTDETR_PALLAS_VARIANT", None)
        shutil.rmtree(work, ignore_errors=True)
    rec["cli_s"] = time.perf_counter() - t_cli
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["nvidia_smi"] = smi
    emit(rec)
    return paths, [c for c in rec["mha"] if c["dtype"] == "bfloat16"]


def convergence_phase(smi, failures, out_dir):
    """tests/torch_convergence_run.py on the card in bfloat16: the JAX
    recipe's two stages on synthetic data, held to the JAX held-out bounds."""
    import contextlib

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synth import make_fscd147
    from torch_convergence_run import BOUNDS, TREE, run, within_bounds

    t = time.perf_counter()
    work = tempfile.mkdtemp(prefix="convergence_")
    log = os.path.join(out_dir, "convergence.txt")
    os.makedirs(out_dir, exist_ok=True)
    try:
        root = make_fscd147(os.path.join(work, "data"), **TREE)
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            summary = run(root, os.path.join(work, "out"), steps1=300, steps2=1500, lr2=1e-3,
                          device="cuda", dtype="bfloat16")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = within_bounds(summary)
    if not ok:
        failures.append(("convergence below the JAX bounds", summary))
    emit({"phase": "convergence", "dtype": "bfloat16", "steps": [300, 1500], "lr2": 1e-3,
          "bounds": BOUNDS, "within_bounds": ok, "summary": summary,
          "phase_wall_s": time.perf_counter() - t, "nvidia_smi": smi})


# ---------------------------------------------------------------- ddp

DDP_WORLD = 2  # processes of the shared-card world (a)
DDP_BATCH = 8  # images a rank a step
DDP_T = (700, 128)  # target capacities, in turns (the train phase's)
DDP_PLAN = tuple((11 + i, DDP_T[i % 2]) for i in range(4))  # (seed, T) of each global batch
DDP_UNEVEN = 19  # samples: a global batch of 16, then 3 (rank 1's slice all padding)
DDP_LR = 1e-4
# float32, a world of 2 against one process on the same global batches and
# the same match: the losses and gradient norm (relative), and the weights
# within the Adam bound of tests/test_torch_train.py (a weight whose gradient
# is float32 noise moves by up to lr a step either way)
DDP_TOL = 2e-4
DDP_WEIGHT_TOL = 2 * len(DDP_PLAN) * DDP_LR
REMAT_GRAD_TOL = 1e-4  # float32, remat on vs off: max |diff| / max |grad| of each tensor
REMAT_STEPS = 3  # timed bf16 steps a turn (off, on)
DDP_JOIN_S = 300
# where and at what size the phase runs (a CPU rehearsal shrinks these; the
# spawned ranks take them from their spec)
DDP_DEVICE = "cuda"
DDP_SIZE = 592
DDP_MODEL = {}  # stage2_config overrides


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ddp_global_batch(seed, T, size, B):
    """The global batch of (a): image 0 keeps 40 of T targets, so the ranks'
    valid and matched counts differ."""
    return train_batch(np.random.default_rng(seed), B, size, T, n_valid_first=40)


class DdpDataset:
    """Stage-2 samples of size x size for the uneven epoch (c): a uint8 image,
    10-120 target boxes (cxcywh) and the three exemplars, from a seed per
    index."""

    def __init__(self, n, size):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(500 + i)
        boxes = rng.uniform(0.2, 0.7, (int(rng.integers(10, 121)), 4)).astype(np.float32)
        boxes[:, 2:] = rng.uniform(0.02, 0.2, (len(boxes), 2))
        return {"image": rng.integers(0, 256, (self.size, self.size, 3), dtype=np.uint8),
                "boxes": boxes, "exemplar_boxes": np.asarray(EXEMPLARS, np.float32),
                "image_name": f"{i}.jpg"}

    def image_size(self, i):
        return (self.size, self.size)


def recording_matcher(store, replay=None, rows=None):
    """(matching.batched_match, a matcher that calls it and keeps each
    call's assignment on the host). With ``replay`` (a list of (tgt2query,
    matched) of another run) the matcher returns that run's ``rows`` of its
    next entry instead: the auction still launches and its own assignment
    is kept, but the loss takes the other run's match."""
    from countdetr_tpu_torch.ops import matching

    solve = matching.batched_match
    calls = iter(replay or ())

    def match(*a, **k):
        tq, m = solve(*a, **k)
        store.append((tq.cpu(), m.cpu()))
        if replay is None:
            return tq, m
        rtq, rm = next(calls)
        return rtq[rows].to(tq.device), rm[rows].to(m.device)

    return solve, match


def state_digest(state):
    """sha256 of each tensor of a Trainer state (bytes on the host), and the
    other leaves as they are."""
    import hashlib

    out = {}
    for k, v in flat_state(state):
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            out[k] = f"{t.dtype}{tuple(t.shape)}" + hashlib.sha256(
                t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
        else:
            out[k] = repr(v)
    return out


def ddp_rank(rank, world, store, spec, out_path):
    """One rank of the world (a), (c), (d): started with spawn by ddp_phase.
    Writes its results to ``out_path`` (pickle), then tries NCCL on the
    shared card and writes that outcome beside it."""
    import pickle
    import traceback

    res = {"rank": rank}
    try:
        sys.path.insert(0, REPO)
        import torch.distributed as dist

        from countdetr_tpu_torch.config import TrainConfig, stage2_config
        from countdetr_tpu_torch.core import mesh
        from countdetr_tpu_torch.data.batching import Batcher
        from countdetr_tpu_torch.ops import matching
        from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
        from countdetr_tpu_torch.train import checkpoints as ckpt
        from countdetr_tpu_torch.train import engine
        from countdetr_tpu_torch.train.train_step import Trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, size, bs = spec["device"], spec["size"], spec["batch"]
        mesh.init_distributed(dev, init_method=f"file://{store}", rank=rank, world_size=world,
                              timeout_s=DDP_JOIN_S)
        trainer = Trainer(stage2_config(**spec["model"]), TrainConfig(lr=DDP_LR),
                          device=mesh.local_device(dev), state_dict=torch.load(spec["weights"]),
                          distributed=True)
        res.update(backend=dist.get_backend(), device=str(trainer.device))
        matches = []
        solve, matching.batched_match = recording_matcher(
            matches, torch.load(spec["replay"]), slice(rank * bs, (rank + 1) * bs))
        reset_launches()
        metrics, step_ms = [], []
        for seed, T in spec["plan"]:
            g = ddp_global_batch(seed, T, size, world * bs)
            mine = {k: v[rank * bs:(rank + 1) * bs] for k, v in g.items()}
            _sync(dev)
            t = time.perf_counter()
            m = trainer.step(mine)
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
        matching.batched_match = solve
        res.update(metrics=metrics, step_ms=step_ms, launches=launch_counts(),
                   matches=matches)
        res["model"] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()} \
            if rank == 0 else None

        # (c) an uneven epoch: 19 samples, global batches of 16 and 3
        batcher = Batcher(DdpDataset(spec["uneven"], size), bs, [(size, size)],
                          max_boxes=128, pack_s2d=True, process_index=rank, process_count=world)
        losses, step = [], trainer.step

        def logged(batch):
            out = step(batch)
            losses.append(out["loss"])
            return out

        trainer.step = logged
        reset_launches()
        t = time.perf_counter()
        stats = engine.train_one_epoch(trainer, batcher, 0, log_every=100)
        _sync(dev)
        res["epoch"] = {"stats": stats, "losses": [float(x) for x in losses],
                        "launches": launch_counts(), "bad_steps": int(trainer.bad_steps),
                        "wall_s": time.perf_counter() - t}
        trainer.step = step

        # (d) rank 0 writes the checkpoint, rank 1 waits at the barrier
        t = time.perf_counter()
        ckpt.save_checkpoint(spec["ckpt"], trainer.scheduler.last_epoch, trainer, {"epoch": 0})
        res["save_s"] = time.perf_counter() - t
        res["digest"] = state_digest(ckpt._host_copy(trainer.state_dict()))
    except BaseException:
        res["error"] = traceback.format_exc()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out_path + ".tmp", out_path)
    if "error" in res:
        os._exit(1)
    # NCCL with both ranks on the one card: expected to refuse
    nccl = {}
    try:
        import torch.distributed as dist

        group = dist.new_group(backend="nccl")
        x = torch.ones(1, device=spec["device"])
        dist.all_reduce(x, group=group)
        _sync(spec["device"])
        nccl = {"refused": False, "sum": x.item()}
    except BaseException as e:  # the refusal is the expected outcome
        nccl = {"refused": True, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    with open(out_path + ".nccl", "wb") as f:
        pickle.dump(nccl, f)
    os._exit(0)


def relative(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def ddp_phase(smi, failures):
    """Data parallelism on the card: (a) a world of 2 over gloo on the one
    card against one process on the same global batches (float32), both
    through the kernels; (b) a world of 1 over NCCL, the DDP step against
    the bare Trainer's, and its profile read by utils/xprof.py; (c) an
    uneven epoch whose tail leaves rank 1 only padding; (d) the world's
    checkpoint restored in one process, bit-equal; (e) remat on against
    off. Returns the launch counts of each path."""
    import multiprocessing as mp
    import pickle

    import torch.distributed as dist

    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.core import mesh
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.train import checkpoints as ckpt
    from countdetr_tpu_torch.train.train_step import Trainer, prepare_stage2_batch, stage2_loss
    from countdetr_tpu_torch.utils import xprof

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ddp_")
    rec = {"phase": "ddp", "world": DDP_WORLD, "batch_per_rank": DDP_BATCH,
           "bucket": [DDP_SIZE, DDP_SIZE], "targets_per_step": [T for _, T in DDP_PLAN],
           "tol": DDP_TOL, "weight_tol": DDP_WEIGHT_TOL}
    paths = {}
    try:
        # (a) one process on the global batches of 16, float32
        single = Trainer(stage2_config(**DDP_MODEL), TrainConfig(lr=DDP_LR), device=DDP_DEVICE,
                         seed=0)
        perturb_(single.model, 3)
        weights = os.path.join(work, "weights.pt")
        torch.save({k: v.detach().cpu() for k, v in single.model.state_dict().items()}, weights)
        single_matches = []
        solve, matching.batched_match = recording_matcher(single_matches)
        reset_launches()
        one, one_ms = [], []
        try:
            for seed, T in DDP_PLAN:
                _sync(DDP_DEVICE)
                t = time.perf_counter()
                m = single.step(ddp_global_batch(seed, T, DDP_SIZE, DDP_WORLD * DDP_BATCH))
                _sync(DDP_DEVICE)
                one_ms.append((time.perf_counter() - t) * 1e3)
                one.append({k: v.item() for k, v in m.items()})
        finally:
            matching.batched_match = solve
        paths["ddp_one_process"] = launch_counts()
        torch.save(single_matches, os.path.join(work, "matches.pt"))
        one_model = {k: v.detach().cpu() for k, v in single.model.state_dict().items()}
        trainable = {n for n, p in single.model.named_parameters() if p.requires_grad}
        del single
        torch.cuda.empty_cache()

        # the world of 2 on the shared card: (a), (c), (d)
        ctx = mp.get_context("spawn")
        outs = [os.path.join(work, f"rank{r}.pkl") for r in range(DDP_WORLD)]
        spec = {"weights": weights, "ckpt": os.path.join(work, "ckpt"), "device": DDP_DEVICE,
                "size": DDP_SIZE, "model": DDP_MODEL, "plan": DDP_PLAN, "batch": DDP_BATCH,
                "uneven": DDP_UNEVEN, "replay": os.path.join(work, "matches.pt")}
        t = time.perf_counter()
        procs = [ctx.Process(target=ddp_rank, args=(r, DDP_WORLD, os.path.join(work, "store"),
                                                     spec, outs[r]))
                 for r in range(DDP_WORLD)]
        for p in procs:
            p.start()
        deadline = time.time() + DDP_JOIN_S
        while time.time() < deadline and not all(os.path.exists(o) for o in outs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        # the NCCL attempt after the results: its outcome, or a hang cut at 60 s
        deadline = min(deadline, time.time() + 60)
        while time.time() < deadline and any(p.is_alive() for p in procs) and \
                not all(os.path.exists(o + ".nccl") for o in outs):
            time.sleep(0.5)
        time.sleep(1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        rec["world_wall_s"] = time.perf_counter() - t
        ranks = []
        for r, o in enumerate(outs):
            if not os.path.exists(o):
                failures.append(("ddp rank", r, "no result", procs[r].exitcode))
                ranks.append(None)
                continue
            with open(o, "rb") as f:
                ranks.append(pickle.load(f))
            if "error" in ranks[-1]:
                failures.append(("ddp rank", r, ranks[-1]["error"][-2000:]))
        nccl = []
        for o, x in zip(outs, ranks):
            if os.path.exists(o + ".nccl"):
                with open(o + ".nccl", "rb") as f:
                    nccl.append(pickle.load(f))
            elif x is None or "error" in x:
                nccl.append({"refused": None, "error": "not tried: the rank failed"})
            else:
                nccl.append({"refused": None, "error": "no outcome (hung, killed)"})
        rec["nccl_two_ranks_one_card"] = nccl
        if all(x is not None and "error" not in x for x in ranks):
            world_rec(rec, ranks, one, one_ms, one_model, trainable, single_matches, failures)
            for x in ranks:
                paths[f"ddp_rank{x['rank']}"] = x["launches"]
                paths[f"ddp_epoch_rank{x['rank']}"] = x["epoch"]["launches"]
            # (d) the world's checkpoint in one process
            d = spec["ckpt"]
            restored = Trainer(stage2_config(**DDP_MODEL), TrainConfig(lr=DDP_LR),
                               device=DDP_DEVICE, seed=9)
            step = ckpt.latest_step(d)
            meta = ckpt.restore_checkpoint(d, step, restored)
            digest = state_digest(ckpt._host_copy(restored.state_dict()))
            bad = [k for k in digest if any(digest[k] != x["digest"].get(k) for x in ranks)]
            rec["checkpoint"] = {"step": step, "opt_step": meta["opt_step"],
                                 "tensors": len(digest), "mismatched": bad,
                                 "save_s": [x["save_s"] for x in ranks],
                                 "ranks_equal": ranks[0]["digest"] == ranks[1]["digest"]}
            if bad or step is None or not rec["checkpoint"]["ranks_equal"]:
                failures.append(("ddp checkpoint", bad[:5], step))
            del restored
        shutil.rmtree(os.path.join(work, "ckpt"), ignore_errors=True)
        torch.cuda.empty_cache()

        # (b) a world of 1 over NCCL: the DDP step against the bare Trainer's
        mesh.init_distributed(DDP_DEVICE, init_method=f"file://{os.path.join(work, 'store1')}",
                              rank=0, world_size=1)
        try:
            rec["world1"], paths["ddp_world1_nccl"] = world1_overhead(
                smi, failures, dist, mesh, xprof, work)
        finally:
            mesh.shutdown()

        # (e) remat on against off
        rec["remat"], paths["remat"] = remat_check(failures, prepare_stage2_batch, stage2_loss)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["nvidia_smi"] = smi
    emit(rec)
    return paths


def world_rec(rec, ranks, one, one_ms, one_model, trainable, single_matches, failures):
    """(a) and (c) of the ddp phase into ``rec``: the world's losses, gradient
    norms and weights against one process's, its assignments against the
    process's rows, its launches; the uneven epoch on both ranks."""
    errs = {}
    for x in ranks:
        for i, (got, want) in enumerate(zip(x["metrics"], one)):
            for k, w in want.items():
                errs[k] = max(errs.get(k, 0.0), relative(got[k], w))
    rec["metrics_one_process"] = one
    rec["metrics_rank"] = [x["metrics"] for x in ranks]
    rec["max_rel_err"] = errs
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance", "grad_norm"):
        if not errs.get(k, np.inf) <= DDP_TOL:
            failures.append(("ddp world vs one process", k, errs.get(k)))
    if any(a != b for a, b in zip(ranks[0]["metrics"], ranks[1]["metrics"])):
        failures.append(("ddp ranks report different metrics",))
    w0 = ranks[0]["model"]
    werr = max((w0[k] - one_model[k]).abs().max().item() for k in trainable)
    frozen = max((w0[k] - one_model[k]).abs().max().item() for k in one_model
                 if k not in trainable)
    rec["weights_max_abs_err"] = {"trainable": werr, "frozen": frozen}
    if not (werr <= DDP_WEIGHT_TOL and frozen == 0.0):
        failures.append(("ddp weights", werr, frozen))
    # the auction's own assignments on each rank against the process's rows
    # (the losses took the process's: the auction at B=8 and at B=16 sees
    # costs that differ in float rounding, and near-tied pairs swap)
    diff = []
    for step, (tq1, m1) in enumerate(single_matches):
        n = 0
        for x in ranks:
            tq, m = x["matches"][step]
            rows = slice(x["rank"] * DDP_BATCH, (x["rank"] + 1) * DDP_BATCH)
            n += int(((tq != tq1[rows]) & m).sum()) + int((m != m1[rows]).sum())
        diff.append(n)
    rec["assignment_pairs_differing"] = diff
    rec["matched_pairs"] = [int(m1.sum()) for _, m1 in single_matches]
    rec["step_ms_one_process_b16"] = one_ms
    rec["step_ms_rank"] = [x["step_ms"] for x in ranks]
    rec["backend"] = [x["backend"] for x in ranks]
    rec["launches_rank"] = [x["launches"] for x in ranks]
    want = {"rcda": 12 * len(DDP_PLAN), "rcda_rank1": 0, "mha": 6 * len(DDP_PLAN),
            "auction": len(DDP_PLAN), "pack": 0}
    for x in ranks:
        if x["launches"] != want:
            failures.append(("ddp launches", x["rank"], x["launches"], want))
        if x["backend"] != "gloo":
            failures.append(("ddp backend on a shared card", x["backend"]))
    # (c) the uneven epoch
    ep = [x["epoch"] for x in ranks]
    rec["uneven_epoch"] = {
        "samples": DDP_UNEVEN, "steps": [e["stats"]["steps"] for e in ep],
        "real_samples": [e["stats"]["real_samples"] for e in ep],
        "losses": [e["losses"] for e in ep], "bad_steps": [e["bad_steps"] for e in ep],
        "launches": [e["launches"] for e in ep], "wall_s": [e["wall_s"] for e in ep]}
    u = rec["uneven_epoch"]
    if not (u["steps"] == [2, 2] and u["real_samples"] == [DDP_BATCH + 3, DDP_BATCH]
            and u["losses"][0] == u["losses"][1] and np.isfinite(u["losses"][0]).all()
            and u["bad_steps"] == [0, 0]):
        failures.append(("ddp uneven epoch", u))


def world1_overhead(smi, failures, dist, mesh, xprof, work):
    """(b): bfloat16 stage-2 steps at B=8, the bare Trainer and the same
    weights in DDP over the NCCL world of 1, in turns; one profiled DDP step
    read by utils/xprof.py from the live profiler and from its Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.train.train_step import Trainer

    cfg = stage2_config(**DDP_MODEL, compute_dtype="bfloat16")
    bare = Trainer(cfg, TrainConfig(), device=DDP_DEVICE, seed=0)
    ddp = Trainer(cfg, TrainConfig(), device=DDP_DEVICE, state_dict=bare.model.state_dict(),
                  distributed=True)
    rng = np.random.default_rng(21)
    batches = [train_batch(rng, DDP_BATCH, DDP_SIZE, DDP_T[0], n_valid_first=40),
               train_batch(rng, DDP_BATCH, DDP_SIZE, DDP_T[1])]
    for tr in (bare, ddp):  # warm-up
        for b in batches:
            tr.step(b)
    _sync(DDP_DEVICE)

    def timed(tr, n=4):
        out = []
        for i in range(n):
            t = time.perf_counter()
            tr.step(batches[i % 2])
            _sync(DDP_DEVICE)
            out.append((time.perf_counter() - t) * 1e3)
        return out

    reset_launches()
    turns = {"bare": [], "ddp": []}
    order = ("bare", "ddp", "ddp", "bare")
    for name in order:
        turns[name] += timed(bare if name == "bare" else ddp)
    launches = launch_counts()
    n = 4 * len(order)
    want = {"rcda": 12 * n, "rcda_rank1": 0, "mha": 6 * n, "auction": n, "pack": 0}
    if launches != want:
        failures.append(("ddp world-1 launches", launches, want))
    _sync(DDP_DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("ddp_step"):
            ddp.step(batches[0])
            _sync(DDP_DEVICE)
    events = xprof.events_from_profiler(prof)
    table, busy_s = xprof.op_table(events)
    trace = os.path.join(work, "profile", "trace.json")
    os.makedirs(os.path.dirname(trace))
    prof.export_chrome_trace(trace)
    file_table, file_busy_s = xprof.parse_trace(os.path.dirname(trace))
    by_cat = {}
    for s, n, cat in table.values():
        c = by_cat.setdefault(cat, [0.0, 0])
        c[0] += s * 1e3
        c[1] += n
    comm = {k: [s * 1e3, n] for k, (s, n, cat) in table.items() if cat == "all-reduce"}
    file_events = xprof.load_trace(trace)
    bare_ms, ddp_ms = float(np.median(turns["bare"])), float(np.median(turns["ddp"]))
    bare_prof = profile_calls(lambda: bare.step(batches[0]), 1, top=5)
    out = {"backend": dist.get_backend(), "dtype": "bfloat16", "batch": DDP_BATCH,
           "step_ms_bare": turns["bare"], "step_ms_ddp": turns["ddp"],
           "step_ms_mean_bare": float(np.mean(turns["bare"])),
           "step_ms_mean_ddp": float(np.mean(turns["ddp"])),
           "step_ms_median_bare": bare_ms, "step_ms_median_ddp": ddp_ms,
           "ddp_overhead_ms_median": ddp_ms - bare_ms,
           "ddp_overhead_share_median": ddp_ms / bare_ms - 1.0,
           "bare_step_device_busy_ms": bare_prof["device_busy_ms"],
           "launches": launches, "launches_expected": want,
           "profile_device_ms_by_category": by_cat, "all_reduce_kernels": comm,
           "profile_device_busy_ms": busy_s * 1e3, "trace_file_device_busy_ms": file_busy_s * 1e3,
           "ddp_step_range_device_ms": xprof.range_seconds(events, "ddp_step") * 1e3,
           "ddp_step_range_device_ms_trace_file": xprof.range_seconds(file_events,
                                                                     "ddp_step") * 1e3,
           "gpu_user_annotation_events": sum(e["cat"] == "gpu_user_annotation" for e in events),
           "trace_file_mb": os.path.getsize(trace) / 1e6, "nvidia_smi": smi}
    if out["backend"] != "nccl":
        failures.append(("ddp world of 1", "backend", out["backend"]))
    if not (file_busy_s > 0 and abs(file_busy_s - busy_s) <= 0.01 * busy_s):
        failures.append(("xprof: the trace file and the live profile differ", busy_s, file_busy_s))
    if not by_cat.get("custom-call"):
        failures.append(("xprof: no custom-call kernels in the profile", by_cat))
    del bare, ddp
    torch.cuda.empty_cache()
    return out, launches


def remat_check(failures, prepare_stage2_batch, stage2_loss):
    """(e): remat on against off at B=8, 592x592: float32 losses and
    gradients on the same weights, batch and match; then bfloat16 Trainer
    steps with each, their time, peak memory and launches."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.train.train_step import Trainer

    rng = np.random.default_rng(31)
    batch = train_batch(rng, DDP_BATCH, DDP_SIZE, DDP_T[0], n_valid_first=40)
    tcfg = TrainConfig()
    res, match, base = {}, None, None
    for remat in (False, True):
        model = build_model(stage2_config(**DDP_MODEL, remat=remat), device=DDP_DEVICE,
                            seed=0, state_dict=base).train()
        base = model.state_dict() if base is None else base
        total, parts, match = stage2_loss(model, prepare_stage2_batch(batch, DDP_DEVICE), tcfg,
                                          match=match)
        total.backward()
        res[remat] = ({k: v.item() for k, v in parts.items()},
                      {n: p.grad.detach().clone() for n, p in model.named_parameters()
                       if p.grad is not None})
        del model, total
    (p0, g0), (p1, g1) = res[False], res[True]
    loss_err = max(relative(p1[k], p0[k]) for k in p0)
    grad_err = max(((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp(min=1e-30)).item()
                   for k in g0)
    out = {"dtype_check": "float32", "loss_max_rel_err": loss_err, "grad_max_rel_err": grad_err,
           "grad_tol": REMAT_GRAD_TOL, "grad_tensors": len(g0), "same_tensors": set(g0) == set(g1)}
    if not (loss_err <= 1e-6 and grad_err <= REMAT_GRAD_TOL and set(g0) == set(g1)):
        failures.append(("remat vs no remat", loss_err, grad_err))
    del res, g0, g1
    torch.cuda.empty_cache()
    steps = {}
    launches = None
    for remat in (False, True):
        tr = Trainer(stage2_config(**DDP_MODEL, compute_dtype="bfloat16", remat=remat), tcfg,
                     device=DDP_DEVICE, state_dict=base)
        tr.step(batch)  # warm-up
        _sync(DDP_DEVICE)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ms = []
        for _ in range(REMAT_STEPS):
            t = time.perf_counter()
            tr.step(batch)
            _sync(DDP_DEVICE)
            ms.append((time.perf_counter() - t) * 1e3)
        counts = launch_counts()
        s = steps.setdefault("on" if remat else "off", {"step_ms": [], "peak_memory_gb": []})
        s["step_ms"] += ms
        s["peak_memory_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        s["launches_per_step"] = {k: v // REMAT_STEPS for k, v in counts.items()}
        if remat:
            launches = counts
        s["device_busy_ms"] = profile_calls(lambda: tr.step(batch), 1, top=3)["device_busy_ms"]
        del tr
        torch.cuda.empty_cache()
    for s in steps.values():
        s["step_ms_median"] = float(np.median(s["step_ms"]))
    out["bf16_steps"] = steps
    out["time_ratio_on_off"] = steps["on"]["step_ms_median"] / steps["off"]["step_ms_median"]
    out["device_ratio_on_off"] = (steps["on"]["device_busy_ms"]
                                  / max(steps["off"]["device_busy_ms"], 1e-9))
    out["memory_ratio_on_off"] = (max(steps["on"]["peak_memory_gb"])
                                  / max(steps["off"]["peak_memory_gb"]))
    want_on = {"rcda": 24, "rcda_rank1": 0, "mha": 12, "auction": 1, "pack": 0}
    if steps["on"]["launches_per_step"] != want_on:
        failures.append(("remat launches", steps["on"]["launches_per_step"], want_on))
    return out, launches


# ---------------------------------------------------------------- tp

TP_MESHES = ((1, 2), (2, 2))  # (data, model) of the worlds (a) and (b)
TP_STEPS = {(1, 2): 4, (2, 2): 2}  # float32 steps of each world
TP_BATCH = 8  # images of a global batch
TP_PLAN = tuple((41 + i, DDP_T[i % 2]) for i in range(4))  # (seed, T) of each global batch
TP_BF16_STEPS = 4  # timed bfloat16 steps (e), after 2 of warm-up
TP_FORWARD_TOL = 1e-4  # float32 forward, world (a) against one process
TP_JOIN_S = 300
# the attention kernels at a model rank's shapes: E=256, 8 heads over M=2
TP_E, TP_HEADS = 128, 4


def tp_rank(rank, world, store, spec, out_path):
    """One rank of a tensor-parallel world, (a) or (b) of tp_phase: started
    with spawn. Writes its results to ``out_path`` (pickle)."""
    import pickle
    import traceback

    res = {"rank": rank}
    try:
        sys.path.insert(0, REPO)
        import torch.distributed as dist

        from countdetr_tpu_torch.config import TrainConfig, stage2_config
        from countdetr_tpu_torch.core import mesh, tensor_parallel
        from countdetr_tpu_torch.ops import matching
        from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
        from countdetr_tpu_torch.train import checkpoints as ckpt
        from countdetr_tpu_torch.train.train_step import Trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, size, (D, M) = spec["device"], spec["size"], spec["mesh"]
        mesh.init_distributed(dev, init_method=f"file://{store}", rank=rank, world_size=world,
                              timeout_s=TP_JOIN_S)
        train = TrainConfig(lr=DDP_LR, mesh_shape=(D, M), mesh_axes=("data", "model"))
        full = torch.load(spec["weights"])
        trainer = Trainer(stage2_config(**spec["model"]), train, device=mesh.local_device(dev),
                          state_dict=full, distributed=True)
        m = trainer.mesh
        bs = spec["batch"] // D
        rows = slice(m.data_index() * bs, (m.data_index() + 1) * bs)
        res.update(backend=dist.get_backend(), device=str(trainer.device), coords=m.coords)
        # the shard-then-gather round trip on the card
        local = {k: v.to(trainer.device) for k, v in full.items()}
        back = tensor_parallel.gather_params_tp(
            tensor_parallel.shard_state(local, m.model_index(), M), m)
        res["round_trip_unequal"] = [k for k in local if not torch.equal(back[k], local[k])]
        del local, back
        if spec.get("forward") is not None:  # (a): the float32 forward
            trainer.model.eval()
            with torch.no_grad():
                out = trainer.model(*(torch.from_numpy(a).to(trainer.device)
                                      for a in spec["forward"]))
            res["forward"] = {k: out[k].cpu() for k in ("pred_logits", "pred_boxes", "pred_vars")}
            trainer.model.train()
        matches = []
        solve, matching.batched_match = recording_matcher(matches, torch.load(spec["replay"]),
                                                          rows)
        reset_launches()
        metrics, step_ms = [], []
        for seed, T in spec["plan"]:
            g = ddp_global_batch(seed, T, size, spec["batch"])
            _sync(dev)
            t = time.perf_counter()
            out = trainer.step({k: v[rows] for k, v in g.items()})
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: v.item() for k, v in out.items()})
        matching.batched_match = solve
        res.update(metrics=metrics, step_ms=step_ms, launches=launch_counts(),
                   matches=matches)
        res["replicated"] = state_digest({n: p for n, p in trainer.model.named_parameters()
                                          if getattr(p, "tp_dim", None) is None})
        state = trainer.state_dict()  # gathered over the model group: every rank calls it
        res["model"] = {k: v.detach().cpu() for k, v in state["model"].items()} \
            if rank == 0 else None
        del state
        if spec.get("ckpt"):  # (c): rank 0 writes the gathered state
            t = time.perf_counter()
            ckpt.save_checkpoint(spec["ckpt"], trainer.scheduler.last_epoch, trainer,
                                 {"epoch": 0})
            res["save_s"] = time.perf_counter() - t
            res["digest"] = state_digest(ckpt._host_copy(trainer.state_dict()))
        if spec.get("bf16_plan"):  # (e): bfloat16 step time and peak memory
            del trainer
            cuda = torch.device(dev).type == "cuda"
            if cuda:
                torch.cuda.empty_cache()
            t16 = Trainer(stage2_config(**spec["model"], compute_dtype="bfloat16"), train,
                          device=mesh.local_device(dev), state_dict=full, distributed=True)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            ms = []
            for seed, T in spec["bf16_plan"]:
                g = ddp_global_batch(seed, T, size, spec["batch"])
                _sync(dev)
                t = time.perf_counter()
                t16.step({k: v[rows] for k, v in g.items()})
                _sync(dev)
                ms.append((time.perf_counter() - t) * 1e3)
            res["bf16"] = {"step_ms": ms[2:], "peak_memory_gb":
                           torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    except BaseException:
        res["error"] = traceback.format_exc()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out_path + ".tmp", out_path)
    os._exit(1 if "error" in res else 0)


def run_world(target, world, work, name, spec, failures):
    """``world`` spawned processes of ``target`` meeting at a FileStore in
    ``work``; their pickled results by rank (None where a rank gave none),
    and the wall seconds. Every process is stopped before it returns."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    outs = [os.path.join(work, f"{name}_rank{r}.pkl") for r in range(world)]
    t = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, world, os.path.join(work, f"{name}_store"),
                                              spec, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + TP_JOIN_S
    while time.time() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(2.0)  # the others' results, if they have them
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    ranks = []
    for r, o in enumerate(outs):
        if not os.path.exists(o):
            failures.append((name, "rank", r, "no result", procs[r].exitcode))
            ranks.append(None)
            continue
        with open(o, "rb") as f:
            ranks.append(pickle.load(f))
        if "error" in ranks[-1]:
            failures.append((name, "rank", r, ranks[-1]["error"][-2000:]))
    return ranks, time.perf_counter() - t


def tp_kernel_cases(g):
    """(d): RCDA v3 and MHA at a model rank's shapes (E=128, 4 heads) at
    serving B=32, bfloat16 and float32: RCDA over the 37x37 grid at L=1369
    (the encoder) and 576 (the decoder's cross-attention), MHA at L=S=1369
    (standard attention over the grid, image 0's keys padded) and L=S=576
    (the decoder's self-attention); rank-1 at stage 1's B=8 24x42, L=1008
    and 700."""
    from countdetr_tpu_torch.ops.kernels import mha_kernel, rcda_kernel

    kw = dict(E=TP_E, n=TP_HEADS)
    dts = (torch.bfloat16, torch.float32)
    cases = {"rcda": [rcda_case(rcda_kernel, g, dt, L, **kw) for dt in dts for L in (1369, 576)],
             "rcda_rank1": [rcda_case(rcda_kernel, g, dt, L, variant="rank1", **kw,
                                      **STAGE1_SHAPE) for dt in dts for L in (1008, 700)],
             "mha": [mha_case(mha_kernel, g, dt, B=32, L=L, key_grid=grid, **kw)
                     for dt in dts for L, grid in ((1369, (37, 37, 30, 25)), (576, None))]}
    for c in (c for cs in cases.values() for c in cs):
        c["path"] = "tp"
    return cases


def tp_phase(g, smi, failures):
    """Tensor parallelism on the card: (a) a world of 2 over gloo on the one
    card, mesh (data=1, model=2), float32: the forward against one process,
    4 Trainer steps against one process's on the same global batches and
    match; (b) a world of 4, mesh (2, 2), 2 steps at B=4 a data rank against
    the same process; (c) (b)'s checkpoint, gathered and written by rank 0,
    restored in one process; (d) the attention kernels at a model rank's
    shapes against their plain versions; (e) bfloat16 step time and peak
    memory of (a)'s world against one process. Returns the launch counts of
    each path and (d)'s cases."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.serve import pack_requests
    from countdetr_tpu_torch.train import checkpoints as ckpt
    from countdetr_tpu_torch.train.train_step import Trainer

    t_phase = time.perf_counter()
    rec = {"phase": "tp", "meshes": TP_MESHES, "global_batch": TP_BATCH,
           "bucket": [DDP_SIZE, DDP_SIZE], "targets_per_step": [T for _, T in TP_PLAN],
           "tol": DDP_TOL, "forward_tol": TP_FORWARD_TOL}
    paths = {}
    cases = tp_kernel_cases(g)
    for kind, cs in cases.items():
        for c in cs:
            if not (in_tol(c) and c["finite"] and c.get("dead_row_within_tol", True)):
                failures.append(("tp kernel", kind, c["shape"], c["dtype"], c["max_abs_err"]))
    rec["kernels"] = cases
    work = tempfile.mkdtemp(prefix="tp_")
    try:
        # one process: the float32 forward, then the steps on the global batches
        single = Trainer(stage2_config(**DDP_MODEL), TrainConfig(lr=DDP_LR), device=DDP_DEVICE,
                         seed=0)
        perturb_(single.model, 5)
        weights = os.path.join(work, "weights.pt")
        torch.save({k: v.detach().cpu() for k, v in single.model.state_dict().items()}, weights)
        images, masks, rects, _ = pack_requests(
            make_packed_batch(np.random.default_rng(4), [(DDP_SIZE, DDP_SIZE),
                                                         (DDP_SIZE * 3 // 4, DDP_SIZE * 7 // 8)]),
            (DDP_SIZE, DDP_SIZE))
        single.model.eval()
        with torch.no_grad():
            out = single.model(*(torch.from_numpy(a).to(DDP_DEVICE)
                                 for a in (images, masks, rects)))
        one_forward = {k: out[k].cpu() for k in ("pred_logits", "pred_boxes", "pred_vars")}
        single.model.train()
        single_matches, one, one_ms, one_models = [], [], [], {}
        solve, matching.batched_match = recording_matcher(single_matches)
        reset_launches()
        try:
            for i, (seed, T) in enumerate(TP_PLAN):
                _sync(DDP_DEVICE)
                t = time.perf_counter()
                m = single.step(ddp_global_batch(seed, T, DDP_SIZE, TP_BATCH))
                _sync(DDP_DEVICE)
                one_ms.append((time.perf_counter() - t) * 1e3)
                one.append({k: v.item() for k, v in m.items()})
                if i + 1 in TP_STEPS.values():
                    one_models[i + 1] = {k: v.detach().cpu()
                                         for k, v in single.model.state_dict().items()}
        finally:
            matching.batched_match = solve
        paths["tp_one_process"] = launch_counts()
        torch.save(single_matches, os.path.join(work, "matches.pt"))
        trainable = {n for n, p in single.model.named_parameters() if p.requires_grad}
        del single, out
        torch.cuda.empty_cache()

        # (e)'s batches: 2 of warm-up, then the timed ones, T=700 and 128 in turns
        bf16_plan = [(60 + i % 2, DDP_T[i % 2]) for i in range(2 + TP_BF16_STEPS)]
        base = {"weights": weights, "device": DDP_DEVICE, "size": DDP_SIZE, "model": DDP_MODEL,
                "batch": TP_BATCH, "replay": os.path.join(work, "matches.pt")}
        worlds = {}
        for D, M in TP_MESHES:
            name = f"tp{D}x{M}"
            n = TP_STEPS[(D, M)]
            spec = dict(base, mesh=(D, M), plan=TP_PLAN[:n])
            if (D, M) == TP_MESHES[0]:
                spec.update(forward=(images, masks, rects), bf16_plan=bf16_plan)
            else:
                spec.update(ckpt=os.path.join(work, "ckpt"))
            ranks, wall = run_world(tp_rank, D * M, work, name, spec, failures)
            w = {"wall_s": wall}
            worlds[name] = w
            if not all(x is not None and "error" not in x for x in ranks):
                continue
            tp_world_rec(w, ranks, (D, M), one[:n], one_models[n], trainable, one_forward,
                         failures)
            for x in ranks:
                paths[f"{name}_rank{x['rank']}"] = x["launches"]
            if "bf16" in ranks[0]:
                w["bf16"] = [x["bf16"] for x in ranks]
            if spec.get("ckpt"):  # (c) the world's checkpoint in one process
                restored = Trainer(stage2_config(**DDP_MODEL), TrainConfig(lr=DDP_LR),
                                   device=DDP_DEVICE, seed=9)
                step = ckpt.latest_step(spec["ckpt"])
                meta = ckpt.restore_checkpoint(spec["ckpt"], step, restored)
                digest = state_digest(ckpt._host_copy(restored.state_dict()))
                bad = [k for k in digest
                       if any(digest[k] != x["digest"].get(k) for x in ranks)]
                w["checkpoint"] = {"step": step, "opt_step": meta["opt_step"],
                                   "tensors": len(digest), "mismatched": bad,
                                   "save_s": [x["save_s"] for x in ranks]}
                if bad or step != n:
                    failures.append(("tp checkpoint", bad[:5], step))
                del restored
                shutil.rmtree(spec["ckpt"], ignore_errors=True)
                torch.cuda.empty_cache()
        rec["worlds"] = worlds
        rec["step_ms_one_process_b8_f32"] = one_ms

        # (e) one process's bfloat16 steps, the batches (a)'s world timed
        t16 = Trainer(stage2_config(**DDP_MODEL, compute_dtype="bfloat16"),
                      TrainConfig(lr=DDP_LR), device=DDP_DEVICE, state_dict=torch.load(weights))
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for seed, T in bf16_plan:
            b = ddp_global_batch(seed, T, DDP_SIZE, TP_BATCH)
            _sync(DDP_DEVICE)
            t = time.perf_counter()
            t16.step(b)
            _sync(DDP_DEVICE)
            ms.append((time.perf_counter() - t) * 1e3)
        one16 = {"step_ms": ms[2:], "step_ms_median": float(np.median(ms[2:])),
                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        a = worlds.get(f"tp{TP_MESHES[0][0]}x{TP_MESHES[0][1]}", {})
        if "bf16" in a:
            for r in a["bf16"]:
                r["step_ms_median"] = float(np.median(r["step_ms"]))
            rec["bf16_b8"] = {"one_process": one16, "world_ranks": a["bf16"],
                              "world_over_one": a["bf16"][0]["step_ms_median"]
                              / one16["step_ms_median"]}
        del t16
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    rec["nvidia_smi"] = smi
    emit(rec)
    return paths, cases


def tp_world_rec(w, ranks, shape, one, one_model, trainable, one_forward, failures):
    """A world's results into ``w``, held against one process: the losses and
    gradient norm, the weights, the replicated parameters across each model
    group, the round trip, the forward (a), the launches."""
    D, M = shape
    name = f"tp{D}x{M}"
    errs = {}
    for x in ranks:
        for got, want in zip(x["metrics"], one):
            for k, v in want.items():
                errs[k] = max(errs.get(k, 0.0), relative(got[k], v))
    w.update(metrics_one_process=one, metrics_rank=[x["metrics"] for x in ranks],
             max_rel_err=errs, step_ms_rank=[x["step_ms"] for x in ranks],
             backend=[x["backend"] for x in ranks], coords=[x["coords"] for x in ranks],
             launches_rank=[x["launches"] for x in ranks])
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_variance", "grad_norm"):
        if not errs.get(k, np.inf) <= DDP_TOL:
            failures.append((name, "world vs one process", k, errs.get(k)))
    w0 = ranks[0]["model"]
    werr = max((w0[k] - one_model[k]).abs().max().item() for k in trainable)
    frozen = max((w0[k] - one_model[k]).abs().max().item() for k in one_model
                 if k not in trainable)
    w["weights_max_abs_err"] = {"trainable": werr, "frozen": frozen,
                                "tol": 2 * len(one) * DDP_LR}
    if not (werr <= 2 * len(one) * DDP_LR and frozen == 0.0 and set(w0) == set(one_model)):
        failures.append((name, "weights", werr, frozen))
    groups = [[ranks[d * M + m] for m in range(M)] for d in range(D)]
    w["replicated_bit_equal"] = all(x["replicated"] == grp[0]["replicated"]
                                    for grp in groups for x in grp)
    w["replicated_tensors"] = len(ranks[0]["replicated"])
    if not w["replicated_bit_equal"]:
        failures.append((name, "replicated parameters differ across a model group"))
    # each rank's own auction on its copy of the outputs, and the metrics
    w["model_group_metrics_equal"] = all(x["metrics"] == grp[0]["metrics"]
                                         for grp in groups for x in grp)
    w["model_group_matches_equal"] = all(
        all(torch.equal(a, b) for ma, mb in zip(x["matches"], grp[0]["matches"])
            for a, b in zip(ma, mb))
        for grp in groups for x in grp)
    if not (w["model_group_metrics_equal"] and w["model_group_matches_equal"]):
        failures.append((name, "a model group's ranks differ", w["model_group_metrics_equal"],
                         w["model_group_matches_equal"]))
    w["round_trip_unequal"] = [x["round_trip_unequal"] for x in ranks]
    if any(w["round_trip_unequal"]):
        failures.append((name, "shard-then-gather", w["round_trip_unequal"]))
    if "forward" in ranks[0]:
        w["forward_max_abs_err"] = {
            k: max((x["forward"][k] - v).abs().max().item() for x in ranks)
            for k, v in one_forward.items()}
        if not all(e <= TP_FORWARD_TOL for e in w["forward_max_abs_err"].values()):
            failures.append((name, "forward", w["forward_max_abs_err"]))
    n = len(one)
    want = {"rcda": 12 * n, "rcda_rank1": 0, "mha": 6 * n, "auction": n, "pack": 0}
    for x in ranks:
        if x["launches"] != want:
            failures.append((name, "launches", x["rank"], x["launches"], want))
        if x["backend"] != "gloo":
            failures.append((name, "backend on a shared card", x["backend"]))


BENCH_RESULT_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
BENCH_METRIC = "images/sec/chip at 600px eval (stage-2 forward)"
BENCH_PER_FORWARD = {"rcda": 12, "rcda_rank1": 0, "mha": 6, "auction": 0, "pack": 0}
# (path, BENCH_* knobs over the bench's defaults: B=32, 592x592, bf16, hi=40,
# lo=10, 3 pairs, packed, the profiler's estimate)
BENCH_RUNS = (("bench", {"BENCH_PAIRS": "1"}),
              ("bench_unpacked", {"BENCH_PACKED": "0", "BENCH_ITERS": "8", "BENCH_PAIRS": "1"}),
              ("bench_f32", {"BENCH_DTYPE": "float32", "BENCH_ITERS": "8", "BENCH_PAIRS": "1"}))
BENCH_PROFILE_ITERS = 5
BENCH_TIMEOUT_S = 600


def python_module(module, args=(), env_over=None, timeout=BENCH_TIMEOUT_S):
    """``python -m module args`` from the repository root, with the BENCH_*
    variables of this process's environment dropped and ``env_over`` set;
    (exit code, stdout, stderr, seconds). A run past ``timeout`` is killed."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(env_over or {})
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t


def bench_run(name, env_over, kind, failures):
    """One ``python -m countdetr_tpu_torch.bench`` run and its checks: exit
    0, the JAX bench's line last on stdout (its keys and ``device`` only, a
    finite positive value, vs_baseline = round(value / 19, 2)), the stderr
    line's estimator and launches a forward. Returns its record."""
    rc, out, err, seconds = python_module("countdetr_tpu_torch.bench", env_over=env_over)
    rec = {"knobs": env_over, "exit": rc, "seconds": seconds}
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    stats = None
    for line in reversed(err.strip().splitlines()):
        if line.startswith("{") and '"estimator"' in line:
            stats = json.loads(line)
            break
    rec.update(result=result, stats=stats)
    if rc != 0 or result is None or stats is None:
        rec.update(stdout_tail=out[-2000:], stderr_tail=err[-4000:])
        failures.append((name, "exit", rc, "result line" if result else "no result line"))
        return rec
    value = result.get("value") if isinstance(result, dict) else None
    if not (isinstance(value, (int, float)) and set(result) == BENCH_RESULT_KEYS
            and result["metric"] == BENCH_METRIC and result["unit"] == "img/s/chip"
            and result["device"] == kind and math.isfinite(value) and value > 0
            and result["vs_baseline"] == round(value / 19.0, 2)):
        failures.append((name, "result line", result))
    if stats["estimator"] != "device_profile":
        failures.append((name, "estimator", stats["estimator"]))
    if stats["launches_per_forward"] != BENCH_PER_FORWARD:
        failures.append((name, "launches a forward", stats["launches_per_forward"]))
    return rec


def bench_phase(smi, failures, serving_img_per_s=None):
    """The serving bench entry points as a user runs them, each in its own
    process: ``python -m countdetr_tpu_torch.bench`` (``BENCH_RUNS``: its
    defaults but one timing pair, then unpacked and float32 images), and ``python -m
    countdetr_tpu_torch.cli.profile_eval --iters 5`` (its custom-call
    category non-zero and holding the RCDA and MHA kernels). Returns each
    bench run's launch counts by path."""
    from countdetr_tpu_torch.utils import xprof

    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    rec = {"phase": "bench", "nvidia_smi": smi, "serving_b32_img_per_s": serving_img_per_s}
    for name, env_over in BENCH_RUNS:
        rec[name] = bench_run(name, env_over, kind, failures)
    work = tempfile.mkdtemp(prefix="bench_profile_")
    try:
        trace_dir, summary_path = os.path.join(work, "trace"), os.path.join(work, "summary.json")
        rc, out, err, seconds = python_module(
            "countdetr_tpu_torch.cli.profile_eval",
            ["--iters", str(BENCH_PROFILE_ITERS), "--trace_dir", trace_dir,
             "--summary", summary_path])
        prof = {"exit": rc, "seconds": seconds}
        if rc != 0:
            prof.update(stdout_tail=out[-2000:], stderr_tail=err[-4000:])
            failures.append(("profile_eval", "exit", rc))
        else:
            with open(summary_path) as f:
                summary = json.load(f)
            table, _ = xprof.parse_trace(trace_dir)
            custom = sorted(n for n, (_s, _c, cat) in table.items() if cat == "custom-call")
            env_ms = summary["while_envelope_s"] * 1e3 / BENCH_PROFILE_ITERS
            prof.update(
                envelope_ms_per_forward=env_ms,
                img_per_s=summary["batch"] * 1e3 / env_ms if env_ms > 0 else None,
                total_ms_per_forward=summary["total_s"] * 1e3 / BENCH_PROFILE_ITERS,
                ms_per_forward_by_category={
                    c: d * 1e3 / BENCH_PROFILE_ITERS for c, d in sorted(
                        summary["by_category"].items(), key=lambda kv: -kv[1])},
                custom_call_kernels=custom,
                top_ops=[{k: op[k] for k in ("name", "s", "count", "category")}
                         for op in summary["top_ops"][:10]])
            if not (summary["by_category"].get("custom-call", 0.0) > 0
                    and any("rcda" in n for n in custom) and any("mha" in n for n in custom)):
                failures.append(("profile_eval", "custom-call", summary["by_category"], custom))
        rec["profile_eval"] = prof
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stats = (rec["bench"].get("stats") or {})
    rec["rates"] = {k: stats.get(k) for k in (
        "device_profile_img_per_s", "wall_img_per_s", "busy_img_per_s",
        "profiled_wall_img_per_s", "device_idle_share", "envelope_ms_per_forward",
        "gpu_user_annotation_ms_per_forward")}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return {name: (rec[name].get("stats") or {}).get(
        "launches", {"rcda": 0, "rcda_rank1": 0, "mha": 0, "auction": 0, "pack": 0})
        for name, _ in BENCH_RUNS}


# serving's pack kernel: the serve_b32 pool's sides (benchmark/traffic/serve_b32.json)
# in its 592 bucket, and a batch of the pool's mean size for the timing
POOL_SIDES = tuple(range(384, 577, 32))
PACK_BUCKET = (592, 592)
PACK_MEAN = (480, 480)


def pack_cases(pack_kernel, rng):
    """The pack kernel against the host pack (``pack_requests``), bit for
    bit: 32 of the serve_b32 pool's sizes, odd sizes (1x1, the bucket's
    own, one row, one column, odd sides) in 592 and 64x96 buckets, one
    image; then the same through a float32 ``Predictor``'s staging (pinned
    buffer, one copy, the kernel) over calls of B=32, 1, 32. Timed at B=32
    of the pool's mean size: kernel_ms (CUDA events, L2-warm, mean of 20)
    against its bytes bound, plain_ms the host pack it replaces
    (``pack_requests``, host clock, mean of 3), plain_torch_ms its plain
    version on the card, stage_ms the Predictor's staging of the batch on
    the host."""
    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.serve import (Predictor, pack_requests, request_boxes,
                                           stage_requests, staged_views, staging_layout)

    def staged(reqs, bucket):
        boxes = request_boxes(reqs)
        buf = torch.zeros(staging_layout(*boxes.shape[:2], bucket)[2], dtype=torch.uint8)
        used, _ = stage_requests(buf, reqs, boxes, bucket)
        dev = buf[:used].cuda()
        return dev, staged_views(dev, *boxes.shape[:2], bucket)[0], used

    def pool(n):
        return [(int(h), int(w)) for h, w in rng.choice(POOL_SIDES, (n, 2))]

    odd = [(1, 1), (592, 592), (1, 592), (592, 1), (591, 577), (383, 415), (2, 3)]
    cases = [("pool B=32", PACK_BUCKET, pool(32)), ("odd", PACK_BUCKET, odd),
             ("odd 64x96", (64, 96), [(63, 95), (64, 96), (1, 1), (33, 7), (64, 1)]),
             ("one image", PACK_BUCKET, [(577, 385)])]
    out = []
    for name, bucket, sizes in cases:
        reqs = make_packed_batch(rng, sizes)
        images, masks, _, _ = pack_requests(reqs, bucket)
        dev, table, _ = staged(reqs, bucket)
        reset_launches()
        got = pack_kernel.pack_images(dev, table, bucket)
        torch.cuda.synchronize()
        out.append({"case": name, "bucket": list(bucket), "batch": len(sizes),
                    "launches": launch_counts()["pack"],
                    "images_identical": bool(np.array_equal(got[0].cpu().numpy(), images)),
                    "mask_identical": bool(np.array_equal(got[1].cpu().numpy(), masks))})
    # the Predictor's path: pinned staging, one non_blocking copy, the kernel
    pred = Predictor(stage2_config(enc_layers=1, dec_layers=1), device="cuda",
                     bucket=PACK_BUCKET, seed=0)
    for name, sizes in (("predictor B=32", pool(32)), ("predictor B=1", [(385, 577)]),
                        ("predictor B=32 again", pool(31) + [(1, 1)])):
        reqs = make_packed_batch(rng, sizes)
        want = pack_requests(reqs, PACK_BUCKET)[:3]
        reset_launches()
        got = pred._upload(*pred._stage(reqs)[:2])
        torch.cuda.synchronize()
        out.append({"case": name, "bucket": list(PACK_BUCKET), "batch": len(sizes),
                    "launches": launch_counts()["pack"],
                    "images_identical": bool(np.array_equal(got[0].cpu().numpy(), want[0])),
                    "mask_identical": bool(np.array_equal(got[1].cpu().numpy(), want[1])),
                    "boxes_identical": bool(np.array_equal(got[2].cpu().numpy(), want[2]))})
    # the time at the pool's mean batch
    reqs = make_packed_batch(rng, [PACK_MEAN] * 32)
    dev, table, used = staged(reqs, PACK_BUCKET)
    B, (H, W) = len(reqs), PACK_BUCKET
    nbytes = used + B * H * W * 3 + B * H * W  # staged in; packed images and mask out
    t = time.perf_counter()
    for _ in range(3):
        pack_requests(reqs, PACK_BUCKET)
    plain_ms = (time.perf_counter() - t) / 3 * 1e3
    t = time.perf_counter()
    for _ in range(3):
        pred._stage(reqs)
    stage_ms = (time.perf_counter() - t) / 3 * 1e3
    out.append({"case": "timed", "shape": {"B": B, "image": list(PACK_MEAN),
                                           "bucket": list(PACK_BUCKET)},
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "kernel_ms": cuda_ms(lambda: pack_kernel.pack_images(dev, table, PACK_BUCKET), 20),
                "plain_torch_ms": cuda_ms(
                    lambda: pack_kernel.pack_images_plain(dev, table, PACK_BUCKET), 5),
                "plain_ms": plain_ms, "stage_ms": stage_ms})
    del pred
    torch.cuda.empty_cache()
    return out


def pack_ok(c):
    return c["case"] == "timed" or (c["launches"] == 1 and c["images_identical"]
                                    and c["mask_identical"] and c.get("boxes_identical", True))


def make_packed_batch(rng, sizes):
    """Requests of the given (h, w) with 3 exemplar boxes inside each image."""
    reqs = []
    for h, w in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        xy = rng.uniform(0.05, 0.7, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.03, 0.25, (3, 2))], 1)
        reqs.append((img, boxes.astype(np.float32)))
    return reqs


def auction_plan(auction_kernel, P, O):
    C, resident, smem = auction_kernel.cluster_plan(1, P, O)
    return {"cluster": C, "resident": resident, "dynamic_smem": smem,
            "max_active_clusters": auction_kernel.max_active_clusters(P, O, C, resident)}


def kernel_name(mangled):
    """`name<D>` of a mangled `..._kernel` template, else the mangled name:
    each name in a mangled symbol follows its length in digits."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):  # a hash may run into the length
            name = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if name.endswith("_kernel"):
                t = re.match(r"ILi(\d+)E", mangled[m.end() + len(name):])
                return name + (f"<{t.group(1)}>" if t else "")
    return mangled


def ptxas_report(build_dir, names):
    """Each kernel's registers, spills and static shared memory, and the
    compiler's warnings, from the build logs (``_build/<name>.log``,
    nvcc with ptxas -v)."""
    out = {}
    for name in names:
        path = os.path.join(build_dir, f"{name}.log")
        if not os.path.exists(path):
            out[name] = "no build log (library built before this run)"
            continue
        entries, warnings, cur = [], [], None
        with open(path) as f:
            for line in f:
                if re.search(r"warning|C75\d\d", line):  # e.g. C7514: wgmma serialized
                    warnings.append(line.strip()[:200])
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    cur = {"function": kernel_name(m.group(1))}
                    entries.append(cur)
                    continue
                if cur is None:
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur["registers"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", line)
                    cur["static_smem"] = int(sm.group(1)) if sm else 0
        out[name] = {"kernels": entries, "warnings": warnings}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+",
                    choices=("rcda", "rank1", "mha", "auction", "pack") + PHASES,
                    help="build, then check only these kernels (cases and edge cases), or run "
                         "only these of the engine, cli, defaults and convergence phases, and "
                         "stop")
    ap.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"),
                    help="directory for the engine, cli and convergence phases' outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.ops.kernels import (_build, auction_kernel, mha_kernel, pack_kernel,
                                                 rcda_kernel)
    from countdetr_tpu_torch.serve import Predictor, pack_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)

    # 1. device and kernel build
    t0 = time.perf_counter()
    build_s = _build.build()
    build_wall = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "build_wall_s": build_wall,
          "rates": card_rates(), "ptxas": ptxas_report(str(_build.BUILD_DIR), _build.SOURCES),
          # the RCDA kernels' dynamic shared memory a block, bf16, d=32
          "rcda_dynamic_smem": {f"{src} {H}x{W}": rcda_kernel._lib(src)[1](1, 32, H, W)
                                for src in ("rcda", "rcda_rank1")
                                for H, W in ((37, 37), (24, 42))},
          # the auction's plan, shared memory a block and clusters resident at
          # once on the matcher's shapes (P x O)
          "auction_plan": {f"{P}x{O}": auction_plan(auction_kernel, P, O)
                           for P, O in ((576, 700), (128, 576), (576, 5600), (700, 900),
                                        (128, 900), (900, 5600))}})

    # 2. each kernel against its plain version, at the main path's shapes
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.only and set(args.only) <= set(PHASES):
        failures = []
        if "bench" in args.only:
            bench_phase(smi, failures)
        if "engine" in args.only:
            engine_phase(smi, failures, args.out)
        if "cli" in args.only:
            cli_phase(smi, failures, args.out)
        if "defaults" in args.only:
            defaults_phase(np.random.default_rng(8), smi, failures)
        if "longtail" in args.only:
            longtail_phase(g, smi, failures, args.out)
        if "ddp" in args.only:
            ddp_phase(smi, failures)
        if "tp" in args.only:
            tp_phase(torch.Generator(device="cuda").manual_seed(11), smi, failures)
        if "convergence" in args.only:
            convergence_phase(smi, failures, args.out)
        if failures:
            print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
            return 1
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.only:
        return only_kernels([k for k in args.only if k not in PHASES], g, rcda_kernel,
                            mha_kernel, auction_kernel, pack_kernel, matching)
    # B=32: the serving throughput batch; B=8 bf16: the train step's
    rcda_cases = [rcda_case(rcda_kernel, g, dt, L) for L in (1369, 576)
                  for dt in (torch.bfloat16, torch.float32)]
    rcda_cases += [rcda_case(rcda_kernel, g, torch.bfloat16, L, B=8) for L in (1369, 576)]
    # stage 1: B=8 in the 384x672 bucket, C5 24x42, the encoder
    # (L = H*W = 1008, image 1 padded) and the decoder over the 700 tier;
    # both variants, both dtypes; the rank-1 kernel at B=32 37x37 too
    rank1_cases = []
    for dt in (torch.bfloat16, torch.float32):
        for L in (1008, 700):
            rcda_cases.append(rcda_case(rcda_kernel, g, dt, L, **STAGE1_SHAPE))
            rank1_cases.append(rcda_case(rcda_kernel, g, dt, L, variant="rank1", **STAGE1_SHAPE))
        for L in (1369, 576):
            rank1_cases.append(rcda_case(rcda_kernel, g, dt, L, variant="rank1"))
    mha_cases = [mha_case(mha_kernel, g, dt) for dt in (torch.bfloat16, torch.float32)]
    mha_cases += [mha_case(mha_kernel, g, torch.bfloat16, B=8)]
    # the pseudo-label point tiers: 700 and 5600
    mha_cases += [mha_case(mha_kernel, g, torch.bfloat16, B=8, L=L) for L in (700, 5600)]
    edges = edge_cases(rcda_kernel, mha_kernel, g)
    # the learned prior's 900 queries (the decoder's RCDA and MHA at serving
    # B=32, MHA at training B=8), drawn after the cases above. The cases above
    # keep their draw position, so their numbers stay comparable from run to
    # run (the RCDA tolerance is absolute, and one bf16 ulp exceeds it at
    # outputs >= 2: ROADMAP Queue 3). Add new cases after them; the longtail
    # phase draws its own last of all.
    rcda_cases += [rcda_case(rcda_kernel, g, torch.bfloat16, 900)]
    mha_cases += [mha_case(mha_kernel, g, torch.bfloat16, B=B, L=900) for B in (32, 8)]
    # float32 (the CLI's default dtype): the decoder's self-attention at B=8
    # over the 700 and 576 query tiers
    mha_cases += [mha_case(mha_kernel, g, torch.float32, B=8, L=L) for L in (700, 576)]
    determinism = f32_determinism(rcda_kernel, mha_kernel, g)
    auctions = auction_cases(auction_kernel, matching, np.random.default_rng(1))
    packs = pack_cases(pack_kernel, np.random.default_rng(2))
    torch.cuda.synchronize()
    failures = [("edge", c) for c in edges if not in_tol(c)]
    failures += [("pack", c) for c in packs if not pack_ok(c)]
    failures += [("auction", c["case"]) for c in auctions if not c["identical"]]
    failures += [("auction", c["case"], "cluster", x["cluster"]) for c in auctions
                 for x in c["sweep"] if not x["identical"]]
    capped = next(c for c in auctions if c["case"].endswith("cap 5"))
    if not capped["unassigned"]:
        failures.append(("auction", "the iteration cap left no -1", capped["case"]))
    for c in rcda_cases + rank1_cases + mha_cases:
        if not (in_tol(c) and c["finite"]):
            failures.append(("kernel", c["shape"], c["dtype"], c["max_abs_err"]))
    for c in mha_cases:
        if not (c["dead_row_finite"] and c["dead_row_within_tol"]):
            failures.append(("mha dead row", c["dtype"], c["dead_row_uniform_err"]))
    failures += [("determinism", c) for c in determinism
                 if not (c["deterministic"] and c["batch_invariant"])]
    emit({"phase": "kernels", "rcda": rcda_cases, "rcda_rank1": rank1_cases, "mha": mha_cases,
          "auction": auctions, "pack": packs, "edge": edges, "determinism": determinism})

    # 3. full-width float32 parity: card (kernels) against CPU (plain)
    cfg32 = stage2_config()
    cpu_model = build_model(cfg32, device="cpu", seed=0)
    gpu_model = build_model(cfg32, device="cuda", state_dict=cpu_model.state_dict())
    rng = np.random.default_rng(0)
    images, masks, rects, _ = pack_requests(
        make_packed_batch(rng, [(592, 592), (430, 511)]), (592, 592))
    with torch.inference_mode():
        out_gpu = gpu_model(*(torch.from_numpy(a).cuda() for a in (images, masks, rects)))
        out_cpu = cpu_model(*(torch.from_numpy(a) for a in (images, masks, rects)))
    parity = {}
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        a, b = out_gpu[key].cpu(), out_cpu[key]
        parity[key] = {"max_abs_err": (a - b).abs().max().item(),
                       "finite": bool(torch.isfinite(a).all())}
        if not (parity[key]["max_abs_err"] <= PARITY_TOL and parity[key]["finite"]):
            failures.append(("parity", key, parity[key]))
    emit({"phase": "parity", "batch": 2, "bucket": [592, 592], "padded_image": [430, 511],
          "dtype": "float32", "tol": PARITY_TOL, "outputs": parity})
    del cpu_model, gpu_model, out_gpu

    # 4. stage-2 serving: a bfloat16 predictor answering 3 batches of 8 requests
    cfg = stage2_config(compute_dtype="bfloat16")
    pred = Predictor(cfg, device="cuda", bucket=(592, 592), seed=0)
    batches = [make_packed_batch(rng, [tuple(int(x) for x in rng.integers(200, 593, 2))
                                       for _ in range(7)] + [(592, 592)]) for _ in range(3)]
    pred.predict(batches[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    reset_launches()
    counts, latencies_ms = [], []
    for reqs in batches:
        t = time.perf_counter()
        results = pred.predict(reqs)
        latencies_ms.append((time.perf_counter() - t) * 1e3)
        counts.append([r["count"] for r in results])
        for r in results:
            if not (np.isfinite(r["boxes_cxcywh_px"]).all() and np.isfinite(r["scores"]).all()
                    and np.isfinite(r["threshold"])):
                failures.append(("serving", "non-finite output"))
    launches = launch_counts()
    want = {"rcda": 12 * len(batches), "rcda_rank1": 0, "mha": 6 * len(batches), "auction": 0,
            "pack": len(batches)}
    if launches != want:
        failures.append(("launches", launches, want))

    # B=32 all-valid 592x592 forwards, inputs on the card
    big = make_packed_batch(rng, [(592, 592)] * 32)
    images, masks, rects, _ = pack_requests(big, (592, 592))
    dev_in = [torch.from_numpy(a).cuda() for a in (images, masks, rects)]
    with torch.inference_mode():
        out = pred.model(*dev_in)
        finite32 = all(bool(torch.isfinite(v).all()) for v in out.values())
        fwd_ms = cuda_ms(lambda: pred.model(*dev_in), 5, warmup=1)
        prof = profile_calls(lambda: pred.model(*dev_in), 2)
    if not finite32:
        failures.append(("serving", "non-finite B=32 output"))
    emit({"phase": "serving", "dtype": "bfloat16", "batches": len(batches), "batch_size": 8,
          "counts": counts, "predict_ms": latencies_ms, "launches": launches,
          "launches_expected": want, "b32_forward_ms": fwd_ms, "b32_img_per_s": 32e3 / fwd_ms,
          "profile": prof, "nvidia_smi": smi})

    del pred, dev_in, out
    torch.cuda.empty_cache()

    # 4b. the serving bench entry points, each in its own process
    bench_launches = bench_phase(smi, failures, 32e3 / fwd_ms)

    # 5. autograd through the kernels: card against CPU
    grad_phase(rng, failures)

    # 6. the stage-2 bfloat16 train step
    train_launches = train_phase(rng, smi, failures)

    # 7. stage 1: float32 parity, the train step, pseudo-labels
    stage1_parity_launches = stage1_parity_phase(rng, failures)
    stage1_launches = stage1_train_phase(rng, smi, failures)
    pseudo_launches = pseudo_label_phase(rng, smi, failures)

    # 8. the JAX CLI's default model options: the learned and sampled
    # priors, aux losses, dropout
    defaults_launches = defaults_phase(rng, smi, failures)
    defaults_main = {k: sum(c[k] for c in defaults_launches.values())
                     for k in ("rcda", "mha", "auction")}
    failures += [("defaults path launched no", k) for k, n in defaults_main.items() if n == 0]

    # 9. the training and evaluation engine over a synthetic FSCD-147 tree
    engine_launches = engine_phase(smi, failures, args.out)

    # 10. the command line over a synthetic FSCD-147 tree (a bare --stage 2
    # among its modes), each mode read with the counters zeroed just before it
    cli_launches = cli_phase(smi, failures, args.out)
    cli_main = {k: sum(c[k] for name, c in cli_launches.items() if not name.startswith("bench"))
                for k in ("rcda", "rcda_rank1", "mha", "auction")}
    failures += [("cli path launched no", k) for k, n in cli_main.items() if n == 0]

    # 11. AnchorDETR's remaining model options: standard attention, three
    # levels, the mask head (its kernel cases draw from g last of all)
    longtail_launches, longtail_mha = longtail_phase(g, smi, failures, args.out)
    longtail_main = {k: sum(c[k] for c in longtail_launches.values())
                     for k in ("rcda", "rcda_rank1", "mha", "auction")}
    failures += [("longtail path launched no", k) for k, n in longtail_main.items() if n == 0]

    # 12. data parallelism: a world of 2 on the shared card against one
    # process, a world of 1 over NCCL, the uneven epoch, the world's
    # checkpoint in one process, remat
    ddp_paths = ddp_phase(smi, failures)
    for path in ("ddp_rank0", "ddp_rank1", "ddp_world1_nccl", "remat"):
        counts_ = ddp_paths.get(path, {})
        failures += [(f"{path} path launched no", k) for k in ("rcda", "mha", "auction")
                     if not counts_.get(k)]

    # 13. tensor parallelism: worlds of 2 and 4 on the shared card, mesh
    # (1, 2) and (2, 2), against one process; the kernels at a rank's shapes
    tp_paths, tp_cases = tp_phase(torch.Generator(device="cuda").manual_seed(11), smi, failures)
    for path in [f"tp{D}x{M}_rank{r}" for D, M in TP_MESHES for r in range(D * M)]:
        counts_ = tp_paths.get(path, {})
        failures += [(f"{path} path launched no", k) for k in ("rcda", "mha", "auction")
                     if not counts_.get(k)]

    # pseudo_label: one timed run of each variant together (the phase line
    # has them apart)
    pseudo_total = {k: pseudo_launches["v3"][k] + pseudo_launches["rank1"][k]
                    for k in pseudo_launches["v3"]}
    paths = {"serving": launches, "train": train_launches, "stage1_train": stage1_launches,
             "pseudo_label": pseudo_total,
             "pseudo_label_f32_v3": pseudo_launches["f32_v3"],
             "pseudo_label_f32_rank1": pseudo_launches["f32_rank1"]}
    paths.update({f"stage1_parity_{v}": c for v, c in stage1_parity_launches.items()})
    paths.update(bench_launches)
    paths.update({f"defaults_{name}": counts_ for name, counts_ in defaults_launches.items()})
    paths.update({f"engine_{name}": counts_ for name, counts_ in engine_launches.items()})
    paths.update({f"cli_{name}": counts_ for name, counts_ in cli_launches.items()})
    paths.update({f"longtail_{name}": counts_ for name, counts_ in longtail_launches.items()})
    paths.update(ddp_paths)
    paths.update(tp_paths)

    def summary(key, replaces, source, cases, main_case, main_count, f32_case=None):
        f32 = {} if f32_case is None else {"f32": {k: f32_case.get(k) for k in (
            "shape", "source", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "cuda_core_bound_ms", "library_ms", "max_abs_err", "tol")}}
        return {**f32, "name": key, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_count,
                "launches_by_path": {path: counts_[key] for path, counts_ in paths.items()},
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "tol": main_case["tol"], "shape": main_case["shape"],
                "dtype": main_case.get("dtype", "float32"), "ms": main_case["kernel_ms"],
                "kernel_ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"], "cases": cases}

    # times at stage 1's shapes (B=8 bf16: the encoder in the
    # 384x672 bucket, MHA over the 5600-point tier); launches from the cli
    # phase's pipeline modes (stage-1 train and test under rank-1, the rest
    # under v3; the bench modes are in launches_by_path only)
    def pick(cases, dtype="bfloat16", **shape):
        return next(c for c in cases if c["dtype"] == dtype
                    and all(c["shape"][k] == v for k, v in shape.items()))

    auction_main = next(c for c in auctions if c["case"] == "576x700 detr")
    emit({"kernels": [
        summary("rcda", "countdetr_tpu/ops/pallas/rcda_kernel.py:213 fused_rcda",
                "countdetr_tpu_torch/csrc/rcda.cu",
                [c for c in rcda_cases + tp_cases["rcda"] if c["dtype"] == "bfloat16"],
                pick(rcda_cases, B=8, L=1008), cli_main["rcda"],
                pick(rcda_cases, B=32, L=1369, dtype="float32")),
        summary("rcda_rank1", "countdetr_tpu/ops/pallas/rcda_kernel.py:153 fused_rcda_rank1",
                "countdetr_tpu_torch/csrc/rcda_rank1.cu",
                [c for c in rank1_cases + tp_cases["rcda_rank1"] if c["dtype"] == "bfloat16"],
                pick(rank1_cases, B=8, L=1008), cli_main["rcda_rank1"],
                pick(rank1_cases, B=8, L=1008, dtype="float32")),
        summary("mha", "countdetr_tpu/ops/pallas/mha_kernel.py:64 fused_mha",
                "countdetr_tpu_torch/csrc/mha.cu",
                [c for c in mha_cases + tp_cases["mha"] if c["dtype"] == "bfloat16"]
                + longtail_mha,
                pick(mha_cases, B=8, S=5600), cli_main["mha"],
                pick(mha_cases, B=32, S=576, dtype="float32")),
        summary("auction", "countdetr_tpu/ops/pallas/auction_kernel.py:130 auction_assign",
                "countdetr_tpu_torch/csrc/auction.cu",
                [{k: c[k] for k in ("case", "max_abs_err", "identical") if k in c}
                 for c in auctions], auction_main, cli_main["auction"]),
    ]})
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def only_kernels(kinds, g, rcda_kernel, mha_kernel, auction_kernel, pack_kernel, matching):
    """The kernels phase restricted to ``kinds``: the main-path cases and the
    edge cases of those kernels; exit status 0 when all are in tolerance."""
    rec = {"phase": "kernels", "only": kinds}
    cases = []
    if "rcda" in kinds:
        rec["rcda"] = [rcda_case(rcda_kernel, g, torch.bfloat16, L) for L in (1369, 576)]
        rec["rcda"] += [rcda_case(rcda_kernel, g, torch.bfloat16, L, **STAGE1_SHAPE)
                        for L in (1008, 700)]
        rec["rcda"] += [rcda_case(rcda_kernel, g, torch.float32, 576)]
        cases += rec["rcda"]
    if "rank1" in kinds:  # the kernels phase's rank-1 cases, then the tp phase's
        rec["rcda_rank1"] = [
            rcda_case(rcda_kernel, g, dt, L, variant="rank1", **kw)
            for dt in (torch.bfloat16, torch.float32)
            for L, kw in ((1008, STAGE1_SHAPE), (700, STAGE1_SHAPE), (1369, {}), (576, {}))]
        rec["rcda_rank1"] += [
            rcda_case(rcda_kernel, g, dt, L, variant="rank1", E=TP_E, n=TP_HEADS, **STAGE1_SHAPE)
            for dt in (torch.bfloat16, torch.float32) for L in (1008, 700)]
        cases += rec["rcda_rank1"]
    if "mha" in kinds:
        rec["mha"] = [mha_case(mha_kernel, g, torch.bfloat16),
                      mha_case(mha_kernel, g, torch.float32)]
        rec["mha"] += [mha_case(mha_kernel, g, torch.bfloat16, B=8, L=L) for L in (576, 700, 5600)]
        cases += rec["mha"]
    if "auction" in kinds:
        rec["auction"] = auction_cases(auction_kernel, matching, np.random.default_rng(1))
    if "pack" in kinds:
        rec["pack"] = pack_cases(pack_kernel, np.random.default_rng(2))
    rec["edge"] = edge_cases(rcda_kernel, mha_kernel, g, kinds)
    # the learned prior's 900 queries, drawn after the cases above, which
    # keep their draw position (see main; ROADMAP Queue 3)
    if "rcda" in kinds:
        rec["rcda"] += [rcda_case(rcda_kernel, g, torch.bfloat16, 900)]
        cases += rec["rcda"][-1:]
    if "mha" in kinds:
        rec["mha"] += [mha_case(mha_kernel, g, torch.bfloat16, B=B, L=900) for B in (32, 8)]
        cases += rec["mha"][-2:]
    # the float32 rows, drawn last
    rec["f32"] = f32_cases(rcda_kernel, mha_kernel, g, kinds)
    f32 = rec["f32"].get("rcda", []) + rec["f32"].get("mha", [])
    emit(rec)
    bad = [c for c in cases + f32 + rec["edge"] if not (in_tol(c) and c.get("finite", True))]
    bad += [c for c in rec.get("mha", []) + rec["f32"].get("mha", [])
            if not (c["dead_row_finite"] and c["dead_row_within_tol"])]
    bad += [c for c in rec["f32"]["determinism"] if not (c["deterministic"] and c["batch_invariant"])]
    bad += [c for c in rec.get("auction", [])
            if not (c["identical"] and all(x["identical"] for x in c["sweep"]))]
    bad += [c for c in rec.get("pack", []) if not pack_ok(c)]
    if bad:
        print(f"chip_smoke: FAILED {bad}", file=sys.stderr)
    return 1 if bad else 0


def profile_calls(fn, calls, top=12):
    """Device time by kernel name over ``calls`` calls of ``fn``
    (torch.profiler), the device's busy share of the wall time, and the
    largest entries."""
    def run():
        for _ in range(calls):
            fn()

    return profile_run(run, top)[1] | {"calls": calls}


def profile_run(fn, top=12):
    """(fn(), its profile): device time by kernel name and category
    (torch.profiler, read by countdetr_tpu_torch/utils/xprof.py), the
    device's busy share of the wall time and the largest entries."""
    from torch.profiler import ProfilerActivity, profile

    from countdetr_tpu_torch.utils import xprof

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernels, copies and memsets: not the ops launching them, not
    # record_function ranges
    table, busy_s = xprof.op_table(xprof.events_from_profiler(p))
    rows = sorted(table.items(), key=lambda kv: kv[1][0], reverse=True)
    busy_us = busy_s * 1e6
    return out, {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "top": [{"name": k[:90], "ms": sec * 1e3, "calls": n, "category": cat}
                for k, (sec, n, cat) in rows[:top]],
    }


if __name__ == "__main__":
    sys.exit(main())

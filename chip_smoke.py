#!/usr/bin/env python3
"""Drive the PyTorch port (countdetr_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as one JSON line:
  device    the card (nvidia-smi name and power limit), its SM count and
            maximum SM clock (the exponential rate of the bound), the kernel
            build, one nvcc per CUDA source (rcda, rcda_rank1, mha, auction),
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
            at B=32 37x37 (L=1369, 576); MHA in bfloat16 at B=8 over the
            pseudo-label point tiers S=700 and S=5600, one row fully masked;
            max error and its tolerance;
            the auction with tolerance 0 (assignments, rounds and bids
            identical) on the matcher's shapes: 8x576x700 transposed on
            random, DETR-shaped and degenerate costs (the DETR-shaped one
            also on clusters of 4, 8 and 16, each timed), 16x576x700 with a
            sparse image in each half (more clusters than the card holds at
            once), 576x128 (targets bid), 2x576x5600 (rows streamed),
            2x576x5601 (streamed as scalar columns), integer ties,
            eps-scaling on 128x128, an iteration cap that leaves -1s; each
            with its cluster plan, and per timed case the microseconds a
            round (kernel_ms over the largest image's rounds); kernel /
            plain / library times (CUDA events; MHA's kernel / library
            ratio), the least time the card
            could take (bytes, operations or softmax exponentials), and the
            host scipy LAP's time for the auction; then the attention kernels
            at a few other shapes (ragged tiles, head dims 16 and 64, long
            keys, the float32 MHA at S=1700 and 5600), untimed;
  parity    the full-width stage-2 model (ResNet-50-DC5, 6+6 layers, 576
            queries) in float32 on the card (kernels) against the same
            weights on the CPU (plain versions), one padded 592x592 image;
  serving   a bfloat16 Predictor answers 3 batches of 8 requests of mixed
            sizes; launch counters are zeroed just before and read just
            after (12 RCDA and 6 MHA launches per forward); then B=32
            all-valid 592x592 forwards are timed and profiled;
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
            rcda_variant "v3" and "rank1";
  stage1_train   stage 1's train path: a bfloat16 stage-1 Trainer takes
            6 steps at B=8, 384x672, the 3 exemplar centres as queries
            (12 RCDA and 6 MHA launches per step); finite losses, frozen
            tensors unchanged, trainable ones moved; step time, img/s, the
            profiler's idle share;
  pseudo_label   stage 1's main path: generate_pseudo_labels over 24
            images of mixed sizes in the three stage-1 buckets, point
            counts in all three tiers (128, 700, 5600; one image with 3700
            points), with perturbed weights, timed in turns under "v3",
            "rank1", "rank1", "v3" after a warm-up run of each: annotation
            counts equal the points, the two JSONs' w, h within 1 px, 12
            RCDA (resp. 12 rank-1) and 6 MHA launches per forward; images/s,
            points/s and a profiled run of each variant.
Then the kernels line with each path's launch counts, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}. Any failure exits
non-zero; without a CUDA device nothing is printed on stdout.

    python3 chip_smoke.py --only auction rank1   # bring-up: build, then
                                                 # only these kernels' cases
                                                 # (rcda, rank1, mha, auction)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # f32 outside tensor cores
TOL = {torch.bfloat16: {"rcda": 2e-2, "mha": 1e-2}, torch.float32: {"rcda": 1e-4, "mha": 1e-4}}
PARITY_TOL = 1e-3
GRAD_TOL = 1e-3  # relative: max |card - cpu| / max |cpu|
EXEMPLARS = [[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6], [0.2, 0.5, 0.4, 0.7]]


def emit(obj):
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


def bound(ops, nbytes, dtype, exps=0):
    """The least milliseconds for the work, and what sets it: the operations
    at the dtype's peak, the bytes at the memory rate, or the softmax
    exponentials at the SFU rate."""
    t = {"operations": ops / PEAK_OPS[dtype], "bytes": nbytes / HBM_BYTES_PER_S,
         "exp": exps / EX2_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


# stage 1's RCDA calls: B=8 in the 384x672 bucket, C5 24x42, image 1 padded
STAGE1_SHAPE = dict(B=8, H=24, W=42, pad=(34, 20))


def rcda_case(rcda_kernel, g, dt, L, B=32, H=37, W=37, E=256, n=8, variant="v3", pad=(30, 25)):
    """One RCDA core call of ``variant`` against its plain version; image 1
    padded to ``pad`` (columns, rows), image 3 to 5 columns."""
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
    return {
        "variant": variant, "shape": {"B": B, "L": L, "H": H, "W": W, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "tol": TOL[dt]["rcda"], "finite": bool(torch.isfinite(got).all()),
        "kernel_ms": cuda_ms(lambda: rcda_kernel.rcda_core(*args, variant), 20),
        "plain_ms": cuda_ms(lambda: plain(*args), 5),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6, "gexp": exps / 1e9,
    }


def mha_case(mha_kernel, g, dt, B=32, L=576, E=256, n=8):
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    d = E // n
    q, k, v = (r(B, L, E) * d**-0.5).to(dt), r(B, L, E).to(dt), r(B, L, E).to(dt)
    bias = torch.zeros(B, L, device=dev)
    bias[0, 500:] = -1e30  # partly masked keys
    bias[1, :] = -1e30  # every key masked: uniform softmax
    got = mha_kernel.mha_core(q, k, v, bias, n)
    torch.cuda.synchronize()
    want = mha_kernel.mha_core_plain(q, k, v, bias, n)
    err = (got.float() - want.float()).abs().max().item()
    del want
    dead = got[1].float()
    uniform_err = (dead - v[1].float().mean(0, keepdim=True)).abs().max().item()
    qh, kh, vh = (x.view(B, L, n, d).transpose(1, 2) for x in (q, k, v))
    mask = bias[:, None, None, :].to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    isz = torch.tensor([], dtype=dt).element_size()
    ops = 4 * B * L * L * E
    nbytes = isz * 4 * B * L * E + 4 * B * L
    exps = B * n * L * L  # one per score
    bound_ms, bound_by = bound(ops, nbytes, dt, exps)
    kernel_ms = cuda_ms(lambda: mha_kernel.mha_core(q, k, v, bias, n), 20)
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0), 20)
    return {
        "shape": {"B": B, "L": L, "S": L, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "tol": TOL[dt]["mha"],
        "finite": bool(torch.isfinite(got).all()),
        "dead_row_finite": bool(torch.isfinite(dead).all()),
        "dead_row_uniform_err": uniform_err,
        "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(lambda: mha_kernel.mha_core_plain(q, k, v, bias, n),
                            5 if L <= 1024 else 2, warmup=1),
        "library_ms": library_ms, "kernel_over_library": kernel_ms / library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6, "gexp": exps / 1e9,
    }


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
            err = (mha_kernel.mha_core(q, k, v, bias, n).float()
                   - mha_kernel.mha_core_plain(q, k, v, bias, n).float()).abs().max().item()
            out.append({"name": "mha", "shape": [B, L, S, E, n], "dtype": str(dt)[6:],
                        "max_abs_err": err, "tol": TOL[dt]["mha"]})
    return out


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
    want, w_rounds, w_bids = auction_kernel.auction_plain(*args, with_stats=True)
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
        bound_ms, bound_by = bound(ops, nbytes, torch.float32)
        kernel_ms = cuda_ms(lambda: auction_kernel.auction_assign(*args), 5)
        rec.update({
            "kernel_ms": kernel_ms, "us_per_round": kernel_ms * 1e3 / max(1, int(rounds.max())),
            "plain_ms": cuda_ms(lambda: auction_kernel.auction_plain(*args), 1, warmup=0),
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
    return cases


def perturb_(model, seed):
    """Seeded noise on every parameter outside the backbone, so the
    zero-initialised ones (the bbox head's last weight, attention biases)
    pass gradients on."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("backbone"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)


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


def reset_launches(*mods):
    for m in mods:
        m.launches = 0
        if hasattr(m, "rank1_launches"):
            m.rank1_launches = 0


def launch_counts(rcda_kernel, mha_kernel, auction_kernel):
    """Every kernel's launches since the counters were last zeroed."""
    return {"rcda": rcda_kernel.launches, "rcda_rank1": rcda_kernel.rank1_launches,
            "mha": mha_kernel.launches, "auction": auction_kernel.launches}


def grad_phase(rng, failures):
    """Autograd through the kernels on the card against the plain path on
    the CPU, float32, same weights, same batch, the card's match."""
    from countdetr_tpu_torch.config import TrainConfig, stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
    from countdetr_tpu_torch.ops.losses import MatchedTargets
    from countdetr_tpu_torch.train.train_step import prepare_stage2_batch, stage2_loss

    cfg, tcfg = stage2_config(enc_layers=2, dec_layers=2), TrainConfig()
    cpu_model = build_model(cfg, device="cpu", seed=1)
    perturb_(cpu_model, 1)
    gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict()).train()
    cpu_model.train()
    batch = train_batch(rng, 2, 256, 64, n_valid_first=30, pad=(200, 176))
    kernels = (rcda_kernel, mha_kernel, auction_kernel)
    reset_launches(*kernels)
    total_g, parts_g, match = stage2_loss(gpu_model, prepare_stage2_batch(batch, "cuda"), tcfg)
    total_g.backward()
    torch.cuda.synchronize()
    launches = launch_counts(*kernels)
    want_launches = {"rcda": 4, "rcda_rank1": 0, "mha": 2, "auction": 1}
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
    from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
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
    kernels = (rcda_kernel, mha_kernel, auction_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*kernels)
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
    launches = launch_counts(*kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_launches = {"rcda": 12 * len(plan), "rcda_rank1": 0, "mha": 6 * len(plan),
                     "auction": len(plan)}
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
    RCDA variants, the same weights."""
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.models.anchor_detr import build_model

    batch = stage1_batch(rng, 2, (384, 672), 700, n_valid=500, pad=(300, 500))
    keys = ("images", "pad_mask", "points", "points_valid")
    rec = {}
    for variant in ("v3", "rank1"):
        cfg = stage1_config(rcda_variant=variant)
        cpu_model = build_model(cfg, device="cpu", seed=0)
        perturb_(cpu_model, 3)
        gpu_model = build_model(cfg, device="cuda", state_dict=cpu_model.state_dict())
        with torch.inference_mode():
            out_gpu = gpu_model(*(torch.from_numpy(batch[k]).cuda() for k in keys))
            out_cpu = cpu_model(*(torch.from_numpy(batch[k]) for k in keys))
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
          "outputs": rec})


def stage1_train_phase(rng, smi, failures):
    """Stage 1's train path: a bfloat16 stage-1 Trainer at full width."""
    from countdetr_tpu_torch.config import TrainConfig, stage1_config
    from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel

    from countdetr_tpu_torch.train.train_step import Trainer

    trainer = Trainer(stage1_config(compute_dtype="bfloat16"), TrainConfig(), device="cuda",
                       seed=0)
    model = trainer.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    batches = [stage1_batch(rng, 8, (384, 672), 3) for _ in range(2)]
    kernels = (rcda_kernel, mha_kernel, auction_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*kernels)
    step_ms, metrics = [], []
    for i in range(6):
        t = time.perf_counter()
        m = trainer.step(batches[i % 2])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = launch_counts(*kernels)
    want = {"rcda": 12 * 6, "rcda_rank1": 0, "mha": 6 * 6, "auction": 0}
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


def pseudo_dataset(rng, n=24):
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


def pseudo_label_phase(rng, smi, failures):
    """Stage 1's main path: pseudo-labelling under both RCDA variants."""
    from countdetr_tpu_torch.config import stage1_config
    from countdetr_tpu_torch.data.batching import Batcher
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops.kernels import auction_kernel, mha_kernel, rcda_kernel
    from countdetr_tpu_torch.train.engine import generate_pseudo_labels, point_tiers

    ds = pseudo_dataset(rng)
    n_points = sum(len(s["points"]) for s in ds)
    n_batches = len(Batcher(ds, 8, STAGE1_BUCKETS, max_points=700, point_tiers=point_tiers(700)))
    tiers = sorted({b["points"].shape[1] for b in Batcher(
        ds, 8, STAGE1_BUCKETS, max_points=700, point_tiers=point_tiers(700))})
    out_dir = tempfile.mkdtemp(prefix="pseudo_labels_")
    kernels = (rcda_kernel, mha_kernel, auction_kernel)
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
    # timed in turns, counters zeroed just before each run and read after
    for v in ("v3", "rank1", "rank1", "v3"):
        torch.cuda.synchronize()
        reset_launches(*kernels)
        t = time.perf_counter()
        generate_pseudo_labels(models[v], ds, paths[v], also_xywh_path=paths[v][:-5] + "_xywh.json",
                               **kw)
        torch.cuda.synchronize()
        rec[v]["seconds"].append(time.perf_counter() - t)
        rec[v]["launches"].append(launch_counts(*kernels))
    jsons, launches_by_variant = {}, {}
    for v, r in rec.items():
        key = "rcda" if v == "v3" else "rcda_rank1"
        want = {"rcda": 0, "rcda_rank1": 0, "mha": 6 * n_batches, "auction": 0}
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
    emit({"phase": "pseudo_label", "dtype": "bfloat16", "images": len(ds),
          "points": n_points, "max_points_in_an_image": max(len(s["points"]) for s in ds),
          "batch_size": 8, "batches": n_batches, "point_tiers": tiers,
          "buckets": [list(x) for x in STAGE1_BUCKETS], "variants": rec,
          "wh_px_max_diff": float(wh_diff.max()),
          "wh_px_mean_abs_diff": float(wh_diff.mean()),
          "wh_px_share_differing": float((wh_diff > 0).mean()),
          "wh_px_mean": float(a[:, 2:].mean()), "nvidia_smi": smi})
    shutil.rmtree(out_dir)
    return launches_by_variant


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
    ap.add_argument("--only", nargs="+", choices=("rcda", "rank1", "mha", "auction"),
                    help="build, then check only these kernels (cases and edge cases) and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from countdetr_tpu_torch.config import stage2_config
    from countdetr_tpu_torch.models.anchor_detr import build_model
    from countdetr_tpu_torch.ops import matching
    from countdetr_tpu_torch.ops.kernels import _build, auction_kernel, mha_kernel, rcda_kernel
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
          "rcda_dynamic_smem": {f"{v} {H}x{W}": rcda_kernel._lib(v)[1](1, 32, H, W)
                                for v in ("v3", "rank1") for H, W in ((37, 37), (24, 42))},
          # the auction's plan, shared memory a block and clusters resident at
          # once on the matcher's shapes (P x O)
          "auction_plan": {f"{P}x{O}": auction_plan(auction_kernel, P, O)
                           for P, O in ((576, 700), (128, 576), (576, 5600))}})

    # 2. each kernel against its plain version, at the main path's shapes
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.only:
        return only_kernels(args.only, g, rcda_kernel, mha_kernel, auction_kernel, matching)
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
    auctions = auction_cases(auction_kernel, matching, np.random.default_rng(1))
    torch.cuda.synchronize()
    failures = [("edge", c) for c in edges if not c["max_abs_err"] <= c["tol"]]
    failures += [("auction", c["case"]) for c in auctions if not c["identical"]]
    failures += [("auction", c["case"], "cluster", x["cluster"]) for c in auctions
                 for x in c["sweep"] if not x["identical"]]
    capped = next(c for c in auctions if c["case"].endswith("cap 5"))
    if not capped["unassigned"]:
        failures.append(("auction", "the iteration cap left no -1", capped["case"]))
    for c in rcda_cases + rank1_cases + mha_cases:
        if not (c["max_abs_err"] <= c["tol"] and c["finite"]):
            failures.append(("kernel", c["shape"], c["dtype"], c["max_abs_err"]))
    for c in mha_cases:
        if not (c["dead_row_finite"] and c["dead_row_uniform_err"] <= c["tol"]):
            failures.append(("mha dead row", c["dtype"], c["dead_row_uniform_err"]))
    emit({"phase": "kernels", "rcda": rcda_cases, "rcda_rank1": rank1_cases, "mha": mha_cases,
          "auction": auctions, "edge": edges})

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
    kernels = (rcda_kernel, mha_kernel, auction_kernel)
    reset_launches(*kernels)
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
    launches = launch_counts(*kernels)
    want = {"rcda": 12 * len(batches), "rcda_rank1": 0, "mha": 6 * len(batches), "auction": 0}
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

    # 5. autograd through the kernels: card against CPU
    grad_phase(rng, failures)

    # 6. the stage-2 bfloat16 train step
    train_launches = train_phase(rng, smi, failures)

    # 7. stage 1: float32 parity, the train step, pseudo-labels
    stage1_parity_phase(rng, failures)
    stage1_launches = stage1_train_phase(rng, smi, failures)
    pseudo_launches = pseudo_label_phase(rng, smi, failures)

    # pseudo_label: one timed run of each variant together (the phase line
    # has them apart)
    pseudo_total = {k: pseudo_launches["v3"][k] + pseudo_launches["rank1"][k]
                    for k in pseudo_launches["v3"]}
    paths = {"serving": launches, "train": train_launches, "stage1_train": stage1_launches,
             "pseudo_label": pseudo_total}

    def summary(key, replaces, source, cases, main_case, main_count):
        return {"name": key, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_count,
                "launches_by_path": {path: counts_[key] for path, counts_ in paths.items()},
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "tol": main_case["tol"], "shape": main_case["shape"],
                "dtype": main_case.get("dtype", "float32"), "ms": main_case["kernel_ms"],
                "kernel_ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"], "cases": cases}

    # times at stage 1's shapes (B=8 bf16: the encoder in the
    # 384x672 bucket, MHA over the 5600-point tier); launches from the
    # pseudo-label runs, the auction's from the stage-2 train step (stage 1
    # has no matching)
    def pick(cases, **shape):
        return next(c for c in cases if c["dtype"] == "bfloat16"
                    and all(c["shape"][k] == v for k, v in shape.items()))

    auction_main = next(c for c in auctions if c["case"] == "576x700 detr")
    emit({"kernels": [
        summary("rcda", "countdetr_tpu/ops/pallas/rcda_kernel.py:213 fused_rcda",
                "countdetr_tpu_torch/csrc/rcda.cu",
                [c for c in rcda_cases if c["dtype"] == "bfloat16"],
                pick(rcda_cases, B=8, L=1008), pseudo_total["rcda"]),
        summary("rcda_rank1", "countdetr_tpu/ops/pallas/rcda_kernel.py:153 fused_rcda_rank1",
                "countdetr_tpu_torch/csrc/rcda_rank1.cu",
                [c for c in rank1_cases if c["dtype"] == "bfloat16"],
                pick(rank1_cases, B=8, L=1008), pseudo_total["rcda_rank1"]),
        summary("mha", "countdetr_tpu/ops/pallas/mha_kernel.py:64 fused_mha",
                "countdetr_tpu_torch/csrc/mha.cu",
                [c for c in mha_cases if c["dtype"] == "bfloat16"],
                pick(mha_cases, B=8, S=5600), pseudo_total["mha"]),
        summary("auction", "countdetr_tpu/ops/pallas/auction_kernel.py:130 auction_assign",
                "countdetr_tpu_torch/csrc/auction.cu",
                [{k: c[k] for k in ("case", "max_abs_err", "identical") if k in c}
                 for c in auctions], auction_main, train_launches["auction"]),
    ]})
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def only_kernels(kinds, g, rcda_kernel, mha_kernel, auction_kernel, matching):
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
    if "rank1" in kinds:  # the kernels phase's rank-1 cases
        rec["rcda_rank1"] = [
            rcda_case(rcda_kernel, g, dt, L, variant="rank1", **kw)
            for dt in (torch.bfloat16, torch.float32)
            for L, kw in ((1008, STAGE1_SHAPE), (700, STAGE1_SHAPE), (1369, {}), (576, {}))]
        cases += rec["rcda_rank1"]
    if "mha" in kinds:
        rec["mha"] = [mha_case(mha_kernel, g, torch.bfloat16),
                      mha_case(mha_kernel, g, torch.float32)]
        rec["mha"] += [mha_case(mha_kernel, g, torch.bfloat16, B=8, L=L) for L in (576, 700, 5600)]
        cases += rec["mha"]
    if "auction" in kinds:
        rec["auction"] = auction_cases(auction_kernel, matching, np.random.default_rng(1))
    rec["edge"] = edge_cases(rcda_kernel, mha_kernel, g, kinds)
    emit(rec)
    bad = [c for c in cases + rec["edge"] if not c["max_abs_err"] <= c["tol"]]
    bad += [c for c in rec.get("mha", []) if not c["dead_row_uniform_err"] <= c["tol"]]
    bad += [c for c in rec.get("auction", [])
            if not (c["identical"] and all(x["identical"] for x in c["sweep"]))]
    if bad:
        print(f"chip_smoke: FAILED {bad}", file=sys.stderr)
    return 1 if bad else 0


def profile_calls(fn, calls, top=12):
    """Device time by kernel name over ``calls`` calls of ``fn``
    (torch.profiler), the device's busy share of the wall time, and the
    largest entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in p.key_averages():
        # kernels only: not the ops launching them, not record_function ranges
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {
        "calls": calls, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for us, k, c in rows[:top]],
    }


if __name__ == "__main__":
    sys.exit(main())

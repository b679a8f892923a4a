#!/usr/bin/env python3
"""Drive the PyTorch port (countdetr_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as one JSON line:
  device    the card (nvidia-smi name and power limit) and the kernel build,
            one nvcc per CUDA source (rcda, mha, auction), all started
            together;
  kernels   each hand-written kernel against its plain PyTorch version at
            the main paths' shapes: RCDA and MHA in bfloat16 and float32 at
            B=32 (serving) and in bfloat16 at B=8 (the train step), max
            error and its tolerance; the auction with tolerance 0
            (assignments, rounds and bids identical) on the matcher's
            shapes: 8x576x700 transposed on random, DETR-shaped and
            degenerate costs, 576x128 (targets bid), 2x576x5600, integer
            ties, eps-scaling on 128x128, an iteration cap that leaves -1s;
            kernel / plain / library times (CUDA events), the least time
            the card could take (bytes or operations), and the host scipy
            LAP's time for the auction; then RCDA and MHA at a few other
            shapes (ragged tiles, head dims 16 and 64), untimed;
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
  train     this slice's main path: a bfloat16 Trainer takes 6 steps at
            B=8, 592x592, alternating T=700 (one image with 40 valid
            targets) and T=128 batches; launch counters zeroed before and
            read after (12 RCDA, 6 MHA and 1 auction launch per step);
            finite losses, frozen tensors unchanged, trainable ones moved;
            step time, img/s, matcher time, peak memory, a profiled step.
Then the kernels line with the main paths' launch counts, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}. Any failure exits
non-zero; without a CUDA device nothing is printed on stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def bound(ops, nbytes, dtype):
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rcda_case(rcda_kernel, g, dt, L, B=32, H=37, W=37, E=256, n=8):
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    d = E // n
    q_row, q_col = (r(B, L, E) * d**-0.5).to(dt), (r(B, L, E) * d**-0.5).to(dt)
    k_row, k_col, v = r(B, W, E).to(dt), r(B, H, E).to(dt), r(B, H, W, E).to(dt)
    bias_row = torch.zeros(B, W, device=dev)
    bias_col = torch.zeros(B, H, device=dev)
    bias_row[1, 30:] = -1e30  # one image padded on the right and bottom
    bias_col[1, 25:] = -1e30
    bias_row[3, 5:] = -1e30  # one narrow image
    args = (q_row, q_col, k_row, k_col, v, bias_row.to(dt), bias_col.to(dt), n)
    got = rcda_kernel.rcda_core(*args)
    torch.cuda.synchronize()
    want = rcda_kernel.rcda_core_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    isz = torch.tensor([], dtype=dt).element_size()
    ops = 2 * B * L * E * (H + W) + 2 * B * L * E * H * W + 2 * B * L * E * H
    nbytes = isz * (2 * B * L * E + B * (W + H) * E + B * H * W * E + B * (W + H) + B * L * E)
    bound_ms, bound_by = bound(ops, nbytes, dt)
    return {
        "shape": {"B": B, "L": L, "H": H, "W": W, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "tol": TOL[dt]["rcda"], "finite": bool(torch.isfinite(got).all()),
        "kernel_ms": cuda_ms(lambda: rcda_kernel.rcda_core(*args), 20),
        "plain_ms": cuda_ms(lambda: rcda_kernel.rcda_core_plain(*args), 5),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
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
    dead = got[1].float()
    uniform_err = (dead - v[1].float().mean(0, keepdim=True)).abs().max().item()
    qh, kh, vh = (x.view(B, L, n, d).transpose(1, 2) for x in (q, k, v))
    mask = bias[:, None, None, :].to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    isz = torch.tensor([], dtype=dt).element_size()
    ops = 4 * B * L * L * E
    nbytes = isz * 4 * B * L * E + 4 * B * L
    bound_ms, bound_by = bound(ops, nbytes, dt)
    return {
        "shape": {"B": B, "L": L, "S": L, "E": E, "heads": n},
        "dtype": str(dt).replace("torch.", ""),
        "max_abs_err": err, "tol": TOL[dt]["mha"],
        "finite": bool(torch.isfinite(got).all()),
        "dead_row_finite": bool(torch.isfinite(dead).all()),
        "dead_row_uniform_err": uniform_err,
        "kernel_ms": cuda_ms(lambda: mha_kernel.mha_core(q, k, v, bias, n), 20),
        "plain_ms": cuda_ms(lambda: mha_kernel.mha_core_plain(q, k, v, bias, n), 5),
        "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
    }


def edge_cases(rcda_kernel, mha_kernel, g):
    """The kernels off the main path's shapes: ragged query tiles, key
    counts that are not a multiple of 16, W < 16, head dims 16 and 64; each
    against its plain version, untimed."""
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        for B, L, H, W, E, n in ((2, 50, 7, 5, 64, 4), (3, 97, 9, 13, 128, 2), (1, 130, 64, 3, 64, 2)):
            q_row, q_col = (r(B, L, E) * (E // n) ** -0.5).to(dt), (r(B, L, E) * (E // n) ** -0.5).to(dt)
            k_row, k_col, v = r(B, W, E).to(dt), r(B, H, E).to(dt), r(B, H, W, E).to(dt)
            bias_row, bias_col = torch.zeros(B, W, device=dev), torch.zeros(B, H, device=dev)
            bias_row[-1, W // 2 + 1:] = -1e30
            bias_col[-1, H // 2 + 1:] = -1e30
            args = (q_row, q_col, k_row, k_col, v, bias_row.to(dt), bias_col.to(dt), n)
            err = (rcda_kernel.rcda_core(*args).float()
                   - rcda_kernel.rcda_core_plain(*args).float()).abs().max().item()
            out.append({"name": "rcda", "shape": [B, L, H, W, E, n], "dtype": str(dt)[6:],
                        "max_abs_err": err, "tol": TOL[dt]["rcda"]})
        for B, L, S, E, n in ((2, 40, 23, 64, 4), (2, 70, 130, 128, 2), (1, 5, 1, 32, 1)):
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
                 valid=None):
    """The kernel against its plain version on one auction problem, tolerance
    0 on assignments, rounds and bids. With ``cost`` (numpy, the matcher's
    (B, Q, T)) it is timed, bounded and set beside the host scipy LAP."""
    args = (benefit, active, eps, cap, scaling)
    got, rounds, bids = auction_kernel.auction_assign(*args, with_stats=True)
    torch.cuda.synchronize()
    want, w_rounds, w_bids = auction_kernel.auction_plain(*args, with_stats=True)
    B, P, O = benefit.shape
    rec = {
        "case": name, "shape": {"B": B, "P": P, "O": O}, "scaling": scaling, "max_iters": cap,
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
        # bid and object; the rows that each round re-reads from L2
        # (l2_mbytes) are traffic the kernel chooses, not the function's
        nbytes = (benefit.numel() * benefit.element_size() + active.numel() * active.element_size()
                  + eps.numel() * eps.element_size() + got.numel() * got.element_size())
        n_bids = float(bids.sum().item())
        ops = 2 * n_bids * O
        bound_ms, bound_by = bound(ops, nbytes, torch.float32)
        rec.update({
            "kernel_ms": cuda_ms(lambda: auction_kernel.auction_assign(*args), 5),
            "plain_ms": cuda_ms(lambda: auction_kernel.auction_plain(*args), 1, warmup=0),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": ops / 1e9,
            "mbytes": nbytes / 1e6, "l2_mbytes": n_bids * O * 4 / 1e6, "library_ms": None,
        })
        t = time.perf_counter()
        scipy_match(cost, valid)
        rec["scipy_host_ms"] = (time.perf_counter() - t) * 1e3  # host time, not the card's
    return rec


def auction_cases(auction_kernel, matching, rng):
    dev = torch.device("cuda")
    cases = []

    def from_cost(name, cost, valid, timed, cap=None):
        c, v = torch.from_numpy(cost).to(dev), torch.from_numpy(valid).to(dev)
        benefit, active, eps, iters_cap, squared = matching.auction_inputs(c, v)
        cases.append(auction_case(auction_kernel, name, benefit, active, eps, cap or iters_cap,
                                  squared, cost=cost if timed else None, valid=valid))

    B, Q = 8, 576
    valid700 = np.ones((B, 700), bool)
    valid700[0, 40:] = False  # one sparse image
    for name, cost in cost_structures(rng, B, Q, 700).items():
        from_cost(f"576x700 {name}", cost, valid700, timed=True)
    valid128 = np.ones((B, 128), bool)
    valid128[0, 40:] = False
    from_cost("576x128 detr (targets bid)", cost_structures(rng, B, Q, 128)["detr"], valid128,
              timed=True)
    valid5600 = np.zeros((2, 5600), bool)
    valid5600[:, :3000] = True
    from_cost("576x5600 detr, 3000 valid", cost_structures(rng, 2, Q, 5600)["detr"], valid5600,
              timed=True)
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
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernels}
    want_launches = {"rcda_kernel": 4, "mha_kernel": 2, "auction_kernel": 1}
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
    """The slice's main path: a bfloat16 Trainer at full width on the card."""
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
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_launches = {"rcda_kernel": 12 * len(plan), "mha_kernel": 6 * len(plan),
                     "auction_kernel": len(plan)}
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


def make_packed_batch(rng, sizes):
    """Requests of the given (h, w) with 3 exemplar boxes inside each image."""
    reqs = []
    for h, w in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        xy = rng.uniform(0.05, 0.7, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.03, 0.25, (3, 2))], 1)
        reqs.append((img, boxes.astype(np.float32)))
    return reqs


def main() -> int:
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
          "cuda": torch.version.cuda, "build_s": build_s, "build_wall_s": build_wall})

    # 2. each kernel against its plain version, at the main path's shapes
    g = torch.Generator(device="cuda").manual_seed(0)
    # B=32: the serving throughput batch; B=8 bf16: the train step's
    rcda_cases = [rcda_case(rcda_kernel, g, dt, L) for L in (1369, 576)
                  for dt in (torch.bfloat16, torch.float32)]
    rcda_cases += [rcda_case(rcda_kernel, g, torch.bfloat16, L, B=8) for L in (1369, 576)]
    mha_cases = [mha_case(mha_kernel, g, dt) for dt in (torch.bfloat16, torch.float32)]
    mha_cases += [mha_case(mha_kernel, g, torch.bfloat16, B=8)]
    edges = edge_cases(rcda_kernel, mha_kernel, g)
    auctions = auction_cases(auction_kernel, matching, np.random.default_rng(1))
    torch.cuda.synchronize()
    failures = [("edge", c) for c in edges if not c["max_abs_err"] <= c["tol"]]
    failures += [("auction", c["case"]) for c in auctions if not c["identical"]]
    capped = next(c for c in auctions if c["case"].endswith("cap 5"))
    if not capped["unassigned"]:
        failures.append(("auction", "the iteration cap left no -1", capped["case"]))
    for c in rcda_cases + mha_cases:
        if not (c["max_abs_err"] <= c["tol"] and c["finite"]):
            failures.append(("kernel", c["shape"], c["dtype"], c["max_abs_err"]))
    for c in mha_cases:
        if not (c["dead_row_finite"] and c["dead_row_uniform_err"] <= c["tol"]):
            failures.append(("mha dead row", c["dtype"], c["dead_row_uniform_err"]))
    emit({"phase": "kernels", "rcda": rcda_cases, "mha": mha_cases, "auction": auctions,
          "edge": edges})

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
    reset_launches(rcda_kernel, mha_kernel, auction_kernel)
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
    launches = {"rcda": rcda_kernel.launches, "mha": mha_kernel.launches,
                "auction": auction_kernel.launches}
    want = {"rcda": 12 * len(batches), "mha": 6 * len(batches), "auction": 0}
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

    # 6. this slice's main path: the bfloat16 train step
    train_launches = train_phase(rng, smi, failures)

    def summary(name_, replaces, source, cases, main_case, serving_count, train_count):
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_count,
                "launches_by_path": {"serving": serving_count, "train": train_count},
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "tol": main_case["tol"], "shape": main_case["shape"],
                "dtype": main_case.get("dtype", "float32"), "ms": main_case["kernel_ms"],
                "kernel_ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"], "cases": cases}

    # times at the train step's shapes (B=8 bf16), whose launches the line reports
    auction_main = next(c for c in auctions if c["case"] == "576x700 detr")
    rcda_main = next(c for c in rcda_cases if c["shape"]["B"] == 8 and c["shape"]["L"] == 1369)
    emit({"kernels": [
        summary("rcda", "countdetr_tpu/ops/pallas/rcda_kernel.py:213 fused_rcda",
                "countdetr_tpu_torch/csrc/rcda.cu",
                [c for c in rcda_cases if c["dtype"] == "bfloat16"], rcda_main,
                launches["rcda"], train_launches["rcda_kernel"]),
        summary("mha", "countdetr_tpu/ops/pallas/mha_kernel.py:64 fused_mha",
                "countdetr_tpu_torch/csrc/mha.cu",
                [c for c in mha_cases if c["dtype"] == "bfloat16"], mha_cases[-1],
                launches["mha"], train_launches["mha_kernel"]),
        summary("auction", "countdetr_tpu/ops/pallas/auction_kernel.py:130 auction_assign",
                "countdetr_tpu_torch/csrc/auction.cu",
                [{k: c[k] for k in ("case", "max_abs_err", "identical") if k in c}
                 for c in auctions], auction_main, 0, train_launches["auction_kernel"]),
    ]})
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


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

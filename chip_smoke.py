#!/usr/bin/env python3
"""Drive the PyTorch port (countdetr_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as one JSON line:
  device    the card (nvidia-smi name and power limit) and the kernel build,
            one nvcc per CUDA source, all started together;
  kernels   each hand-written kernel against its plain PyTorch version at
            the main path's shapes, bfloat16 and float32: max error and its
            tolerance, kernel / plain / library times (CUDA events), and the
            least time the card could take (bytes or operations); then at a
            few other shapes (ragged tiles, head dims 16 and 64), untimed;
  parity    the full-width stage-2 model (ResNet-50-DC5, 6+6 layers, 576
            queries) in float32 on the card (kernels) against the same
            weights on the CPU (plain versions), one padded 592x592 image;
  serving   the main path: a bfloat16 Predictor answers 3 batches of 8
            requests of mixed sizes; launch counters are zeroed just before
            and read just after (12 RCDA and 6 MHA launches per forward);
            then B=32 all-valid 592x592 forwards are timed and profiled.
Then the kernels line with the main path's launch counts, the card's
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
    from countdetr_tpu_torch.ops.kernels import _build, mha_kernel, rcda_kernel
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
    rcda_cases = [rcda_case(rcda_kernel, g, dt, L) for L in (1369, 576)
                  for dt in (torch.bfloat16, torch.float32)]
    mha_cases = [mha_case(mha_kernel, g, dt) for dt in (torch.bfloat16, torch.float32)]
    edges = edge_cases(rcda_kernel, mha_kernel, g)
    torch.cuda.synchronize()
    failures = [("edge", c) for c in edges if not c["max_abs_err"] <= c["tol"]]
    for c in rcda_cases + mha_cases:
        if not (c["max_abs_err"] <= c["tol"] and c["finite"]):
            failures.append(("kernel", c["shape"], c["dtype"], c["max_abs_err"]))
    for c in mha_cases:
        if not (c["dead_row_finite"] and c["dead_row_uniform_err"] <= c["tol"]):
            failures.append(("mha dead row", c["dtype"], c["dead_row_uniform_err"]))
    emit({"phase": "kernels", "rcda": rcda_cases, "mha": mha_cases, "edge": edges})

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

    # 4. the main path: a bfloat16 predictor serving 3 batches of 8 requests
    cfg = stage2_config(compute_dtype="bfloat16")
    pred = Predictor(cfg, device="cuda", bucket=(592, 592), seed=0)
    batches = [make_packed_batch(rng, [tuple(int(x) for x in rng.integers(200, 593, 2))
                                       for _ in range(7)] + [(592, 592)]) for _ in range(3)]
    pred.predict(batches[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    rcda_kernel.launches = 0
    mha_kernel.launches = 0
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
    launches = {"rcda": rcda_kernel.launches, "mha": mha_kernel.launches}
    want = {"rcda": 12 * len(batches), "mha": 6 * len(batches)}
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
        prof = profile_forward(lambda: pred.model(*dev_in))
    if not finite32:
        failures.append(("serving", "non-finite B=32 output"))
    emit({"phase": "serving", "dtype": "bfloat16", "batches": len(batches), "batch_size": 8,
          "counts": counts, "predict_ms": latencies_ms, "launches": launches,
          "launches_expected": want, "b32_forward_ms": fwd_ms, "b32_img_per_s": 32e3 / fwd_ms,
          "profile": prof, "nvidia_smi": smi})

    def summary(name_, replaces, source, cases, main_case, count):
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "max_abs_err": main_case["max_abs_err"],
                "tol": main_case["tol"], "shape": main_case["shape"],
                "dtype": main_case["dtype"], "ms": main_case["kernel_ms"],
                "kernel_ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"], "cases": cases}

    emit({"kernels": [
        summary("rcda", "countdetr_tpu/ops/pallas/rcda_kernel.py:213 fused_rcda",
                "countdetr_tpu_torch/csrc/rcda.cu", rcda_cases, rcda_cases[0],
                launches["rcda"]),
        summary("mha", "countdetr_tpu/ops/pallas/mha_kernel.py:64 fused_mha",
                "countdetr_tpu_torch/csrc/mha.cu", mha_cases, mha_cases[0],
                launches["mha"]),
    ]})
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_forward(fn, top=12):
    """Device time by kernel name over two forwards (torch.profiler), the
    device's busy share of the wall time, and the largest entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only, not the ops launching them
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {
        "forwards": 2, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for us, k, c in rows[:top]],
    }


if __name__ == "__main__":
    sys.exit(main())

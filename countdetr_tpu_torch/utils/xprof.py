"""Device-time tables from torch.profiler traces (countdetr_tpu/utils/xprof.py,
there over jax.profiler's XSpace; the same table shape here).

A table is ``OpTable`` = {name: [seconds, count, category]}: every device
event of a trace (CUDA kernels, memcpys and memsets) summed by name, with a
category from the kernel's name (``name_category``: cuBLAS and CUTLASS
products are "dot", cuDNN convolutions "convolution", NCCL kernels
"all-reduce", copies "copy", the port's RCDA, MHA and auction kernels
"custom-call"). Events come from the Chrome trace that ``--profile``
writes (``load_trace``, ``parse_trace``) or from a live profiler
(``events_from_profiler``, without writing the trace).

``range_seconds`` is the device's busy time inside the CPU ranges of one
``record_function`` name, on any thread (the backward's kernels are
launched from autograd's own threads); ``device_envelope_seconds``, the
counterpart of the JAX package's ``while_envelope_seconds``, is the span
from the first to the last device event of each such range, gaps
included. A device event counts when it starts and ends inside the range,
so the range must wait for the device before it opens and before it
closes (``torch.cuda.synchronize()``): work queued before it would leak
in, work still running at its end would fall out.

    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("step"):
            trainer.step(batch)
            torch.cuda.synchronize()
    events = events_from_profiler(prof)
    table, total = op_table(events)
    step_busy_s = range_seconds(events, "step")
    step_span_s = device_envelope_seconds(events, "step")
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

# per-op record: [total_seconds, event_count, category]
OpTable = Dict[str, List]

# the Chrome trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# CUDA kernel names, in order: the first match gives the category
_CUDA_RULES = (
    (("nccl",), "all-reduce"),
    (("memcpy",), "copy"),
    (("memset",), "memset"),
    (("rcda", "mha_", "auction"), "custom-call"),
    (("cudnn", "convolve", "convolution", "fprop", "dgrad", "wgrad"), "convolution"),
    (("gemm", "cutlass", "cublas", "nvjet", "xmma", "gemv"), "dot"),
    (("elementwise",), "elementwise"),
)


def _base(name: str) -> str:
    """An HLO instruction's base name ('%fusion.12 = ...' -> 'fusion'), or a
    CUDA kernel's function name without 'void ', namespaces, template
    arguments and parameters."""
    s = name.lstrip("%").replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    s = re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1]
    return s.split(" ")[0].split("=")[0].rstrip("0123456789").rstrip(".")


def name_category(name: str) -> str:
    """The category of a device event from its name. The JAX package's
    rules on XLA instruction names ('%loop_convolution_fusion.9' ->
    convolution, '%dot.12' -> dot, '%fusion.4433' -> fusion:fusion), after
    the CUDA ones: NCCL -> all-reduce, memcpy -> copy, memset, the port's
    kernels (rcda, mha, auction) -> custom-call, cuDNN -> convolution,
    cuBLAS / CUTLASS -> dot, PyTorch's elementwise kernels -> elementwise;
    other kernels fall to their function name ('reduce_kernel' -> reduce,
    'DeviceRadixSortSingleTileKernel')."""
    low = name.lower()
    if not low.startswith("%"):
        for keys, cat in _CUDA_RULES:
            if any(k in low for k in keys):
                return cat
    base = _base(name)
    for key in ("convolution", "dot", "while", "copy", "all-reduce",
                "reduce", "custom-call", "infeed", "outfeed"):
        if key in base:
            return key
    if "fusion" in base:
        return "fusion:" + base
    return base or "uncategorized"


def load_trace(path: str) -> List[dict]:
    """The complete events ('ph': 'X') of a Chrome trace: a .json or
    .json.gz file, or the newest such file under a directory."""
    if os.path.isdir(path):
        found = [p for pat in ("*.json", "*.json.gz")
                 for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
        if not found:
            raise RuntimeError(f"no trace .json under {path}")
        path = max(found, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def events_from_profiler(prof) -> List[dict]:
    """A finished torch.profiler profile's events in the Chrome trace's
    form (name, cat, ts and dur in microseconds): CUDA events are "kernel"
    (copies and memsets included; their names say which) or
    "gpu_user_annotation", host events "user_annotation" (record_function
    ranges) or "cpu_op"."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        note = bool(getattr(e, "is_user_annotation", False))
        if e.device_type == DeviceType.CUDA:
            cat = "gpu_user_annotation" if note else "kernel"
        else:
            cat = "user_annotation" if note else "cpu_op"
        out.append({"name": e.name, "cat": cat, "ts": e.time_range.start,
                    "dur": e.time_range.elapsed_us()})
    return out


def op_table(events: Iterable[dict], categories: Sequence[str] = DEVICE_CATEGORIES
             ) -> Tuple[OpTable, float]:
    """({name: [seconds, count, category]}, total seconds) over the events
    of ``categories``."""
    table: OpTable = {}
    total = 0.0
    for e in events:
        if e.get("cat") not in categories:
            continue
        s = float(e["dur"]) / 1e6
        rec = table.setdefault(e["name"], [0.0, 0, name_category(e["name"])])
        rec[0] += s
        rec[1] += 1
        total += s
    return table, total


def parse_trace(path: str, categories: Sequence[str] = DEVICE_CATEGORIES
                ) -> Tuple[OpTable, float]:
    """``op_table`` of the Chrome trace at ``path`` (``load_trace``)."""
    return op_table(load_trace(path), categories)


def _spans(events: Iterable[dict], cat: str, name: str) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of the events of ``cat`` called ``name``."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == cat and e["name"] == name]


def _inside(events: Iterable[dict], ranges, categories) -> List[List[Tuple[float, float]]]:
    """For each range, the (start, end) of the events of ``categories`` that
    start and end inside it."""
    found = [[] for _ in ranges]
    for e in events:
        if e.get("cat") not in categories:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        for i, (lo, hi) in enumerate(ranges):
            if lo <= a and b <= hi:
                found[i].append((a, b))
    return found


def range_seconds(events: Sequence[dict], name: str,
                  categories: Sequence[str] = DEVICE_CATEGORIES) -> float:
    """Seconds of the events of ``categories`` that start and end inside a
    CPU ``record_function`` range called ``name``, summed over its calls;
    0.0 when there is no such range."""
    ranges = _spans(events, "user_annotation", name)
    total = 0.0
    for e in events:
        if e.get("cat") not in categories:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if any(lo <= a and b <= hi for lo, hi in ranges):
            total += float(e["dur"]) / 1e6
    return total


def device_envelope_seconds(events: Sequence[dict], name: str,
                            categories: Sequence[str] = DEVICE_CATEGORIES) -> float:
    """Seconds from the start of the first to the end of the last event of
    ``categories`` that lie inside a CPU ``record_function`` range called
    ``name``, summed over its calls; 0.0 when there is no such range.

    Unlike ``range_seconds``, which sums the events' own durations (busy
    time), the envelope includes the gaps between them, as the JAX
    package's ``while`` envelope includes its loop's gaps. In eager PyTorch
    those gaps are the host's dispatch, which a jitted ``fori_loop`` has
    none of: the envelope sits near the wall clock of a synchronised range,
    and ``range_seconds / device_envelope_seconds`` is the device's busy
    share of it."""
    total = 0.0
    for spans in _inside(events, _spans(events, "user_annotation", name), categories):
        if spans:
            total += (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6
    return total


def annotation_seconds(events: Sequence[dict], name: str) -> float:
    """Seconds of the device-side ("gpu_user_annotation") spans of the
    ``record_function`` range ``name``, summed over its calls: the profiler's
    own reading of the range on the device, a cross-check of
    ``device_envelope_seconds``."""
    return sum(b - a for a, b in _spans(events, "gpu_user_annotation", name)) / 1e6

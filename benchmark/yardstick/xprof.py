"""Device-time readers over torch.profiler's Chrome trace: a frozen copy of
the program's ``countdetr_tpu_torch/utils/xprof.py`` (its name categories,
``load_trace``, ``op_table``, ``range_seconds``,
``device_envelope_seconds``), kept here so that a change to the program
cannot move the yardstick; plus ``busy_intervals``, the union of the device
events inside a range, which the per-layer metrics read.

A device event counts for a range when it starts and ends inside it, so
the range waits for the device before it opens and before it closes.
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


def busy_intervals(events: Sequence[dict], name: str,
                   categories: Sequence[str] = DEVICE_CATEGORIES) -> List[Tuple[float, float]]:
    """The union of the (start, end) microseconds of the events of
    ``categories`` inside the CPU ranges called ``name``, sorted and merged:
    the device's busy time, overlaps counted once."""
    spans = sorted(s for found in _inside(events, _spans(events, "user_annotation", name),
                                          categories) for s in found)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


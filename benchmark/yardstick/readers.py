"""The per-layer metrics' arithmetic; each file under ``benchmark/metrics``
binds one of these to its name. A reader takes the run's context (see
``benchmark/harness.py::Context``) and returns a number, or None when its
run holds nothing to read (a metric that only a traced run reads, in an
untraced run; kernels that no longer match the name rule), never 0 for a
share of a roofline or of a peak.

The profiled sub-window is one ``record_function`` range that waits for
the device as it opens and closes; its device events are read with the
frozen copy of the program's trace readers (``yardstick/xprof.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.yardstick import work, xprof

KERNEL_CATEGORY = "kernel"


def _events_in_range(ctx, categories=xprof.DEVICE_CATEGORIES) -> List[dict]:
    trace = ctx.trace
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.events
              if e.get("cat") == "user_annotation" and e["name"] == trace.range]
    out = []
    for e in trace.events:
        if e.get("cat") in categories:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if any(lo <= a and b <= hi for lo, hi in ranges):
                out.append(e)
    return out


def busy_seconds(ctx) -> float:
    return sum(b - a for a, b in xprof.busy_intervals(ctx.trace.events, ctx.trace.range)) / 1e6


def idle_pct(ctx) -> Optional[float]:
    """100 (1 - busy / envelope) of the profiled sub-window: the envelope
    from its first to its last device event, busy the union of them."""
    if ctx.trace is None:
        return None
    envelope = xprof.device_envelope_seconds(ctx.trace.events, ctx.trace.range)
    if envelope <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx) / envelope)


def mfu(ctx) -> Optional[float]:
    """100 x the FLOPs of the unprofiled window's completed images, each at
    its own size and point count, over the window's seconds at the
    configuration's peak."""
    win = ctx.window
    if not win.images or win.seconds <= 0:
        return None
    flops = sum(work.forward_flops(ctx.model, h, w, n) for h, w, n in win.images)
    return 100.0 * flops / (win.seconds * work.PEAK_FLOPS[ctx.dtype])


def device_ms_per_img(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.images:
        return None
    busy = busy_seconds(ctx)
    return busy * 1e3 / len(ctx.trace.images) if busy > 0 else None


def kernels_per_request(ctx) -> Optional[float]:
    """Kernels (not copies or memsets) that ran in the profiled sub-window,
    over its requests."""
    if ctx.trace is None or not ctx.trace.requests:
        return None
    n = sum(1 for e in _events_in_range(ctx, (KERNEL_CATEGORY,))
            if not e["name"].startswith(("Memcpy", "Memset")))
    return n / ctx.trace.requests if n else None


def _roofline(ctx, prefix: str, which: int) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.images:
        return None
    spent = sum(float(e["dur"]) for e in _events_in_range(ctx, (KERNEL_CATEGORY,))
                if xprof._base(e["name"]).startswith(prefix)) / 1e6
    if spent <= 0:
        return None
    need = work.core_bounds(ctx.model, ctx.trace.images, ctx.dtype)[which]
    return 100.0 * need / spent


def rcda_roofline(ctx) -> Optional[float]:
    """100 x the summed bound of the RCDA calls the profiled forwards need
    (at real sizes) over the device time of the kernels named ``rcda_*``."""
    return _roofline(ctx, "rcda_", 0)


def mha_roofline(ctx) -> Optional[float]:
    """As ``rcda_roofline``, for the MHA calls and the kernels ``mha_*``."""
    return _roofline(ctx, "mha_", 1)


# ------------------------------------------------------------- breakdown ---

def _host_labels(events: Sequence[dict], tid, times: Sequence[float]) -> List[Optional[str]]:
    """For each time (us, ascending), the name of the innermost host event
    of thread ``tid`` open at that time, or None: one sweep with a stack,
    the events of one thread nesting."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("tid") == tid
                   and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")),
                  key=lambda x: (x[0], -x[1]))
    out: List[Optional[str]] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(ctx, top: int = 10) -> Optional[Dict[str, List]]:
    """The device operations that took most time in the profiled sub-window
    (by name), and its idle gaps summed by the host operation open on the
    window's thread at each gap's middle ("python" where none is)."""
    if ctx.trace is None:
        return None
    table, _ = xprof.op_table(_events_in_range(ctx))
    ops = sorted(([name, rec[0]] for name, rec in table.items()), key=lambda r: -r[1])[:top]
    busy = xprof.busy_intervals(ctx.trace.events, ctx.trace.range)
    window = [e for e in ctx.trace.events if e.get("cat") == "user_annotation"
              and e["name"] == ctx.trace.range]
    gaps: Dict[str, float] = {}
    if window and len(busy) > 1:
        spans = [(end, start) for (_, end), (start, _) in zip(busy[:-1], busy[1:])]
        labels = _host_labels(ctx.trace.events, window[0].get("tid"),
                              [(a + b) / 2 for a, b in spans])
        for (a, b), label in zip(spans, labels):
            if label is None or label == ctx.trace.range:
                label = "python"
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda r: -r[1])[:top]
    return {"device_ops": ops, "idle_gaps": idle}


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))

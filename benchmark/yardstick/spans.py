"""Readers of the program's own spans and counters (``countdetr_tpu_torch/
utils/trace.py``) in the profiled sub-window; each file under
``benchmark/metrics`` that reads a span binds one of these to its name.

A span is a ``user_annotation`` event of the Chrome trace; its prefix is its
name up to the first space (``core.rcda B=32 L=1369 37x37 float32`` ->
``core.rcda``). Only spans that lie inside the sub-window's range count. A
device event (kernel, copy, memset) belongs to a span when the host call
that launched it (a ``cuda_runtime`` or ``cuda_driver`` event with the same
``args.correlation``) starts inside the span on the span's thread, however
late the device runs it. Every reader returns None where its spans are
absent (a program without them, an untraced run), and never 0 for a share.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.yardstick import xprof

Interval = Tuple[float, float]
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def prefix(name: str) -> str:
    return name.split(" ", 1)[0]


def _windows(ctx) -> List[Interval]:
    return xprof._spans(ctx.trace.events, "user_annotation", ctx.trace.range)


def spans(ctx, prefixes: Iterable[str]) -> List[Tuple[float, float, object]]:
    """(start, end, tid) in microseconds of the spans called by one of
    ``prefixes`` that lie inside the sub-window."""
    want = set(prefixes)
    windows = _windows(ctx)
    out = []
    for e in ctx.trace.events:
        if e.get("cat") == "user_annotation" and prefix(e["name"]) in want:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if any(lo <= a and b <= hi for lo, hi in windows):
                out.append((a, b, e.get("tid")))
    return out


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals``, sorted and disjoint."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def intersect(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def mean_span_ms(ctx, name: str) -> Optional[float]:
    """The mean duration (ms) of the sub-window's spans called ``name``."""
    if ctx.trace is None:
        return None
    found = spans(ctx, (name,))
    return sum(b - a for a, b, _ in found) / len(found) / 1e3 if found else None


def idle_gaps(ctx) -> Tuple[List[Interval], float]:
    """(the device's idle intervals, the envelope's microseconds) of the
    sub-window: in each of its ranges, the gaps between the merged device
    events from the first to the last, as ``readers.idle_pct`` counts
    them."""
    gaps: List[Interval] = []
    envelope = 0.0
    for found in xprof._inside(ctx.trace.events, _windows(ctx), xprof.DEVICE_CATEGORIES):
        busy = merge(found)
        if busy:
            envelope += busy[-1][1] - busy[0][0]
            gaps += [(end, start) for (_, end), (start, _) in zip(busy[:-1], busy[1:])]
    return gaps, envelope


def idle_share(ctx, inside: str, outside: Optional[str] = None) -> Optional[float]:
    """100 x the device's idle time that falls inside spans ``inside`` and
    outside spans ``outside``, over the envelope (``idle_gaps``)."""
    if ctx.trace is None:
        return None
    within = merge((a, b) for a, b, _ in spans(ctx, (inside,)))
    gaps, envelope = idle_gaps(ctx)
    if not within or envelope <= 0:
        return None
    idle = intersect(gaps, within)
    if outside is not None:
        idle_out = intersect(idle, merge((a, b) for a, b, _ in spans(ctx, (outside,))))
        value = length(idle) - length(idle_out)
    else:
        value = length(idle)
    share = 100.0 * value / envelope
    return share if share > 0 else None


def entry_idle_pct(ctx) -> Optional[float]:
    """100 x the device's idle time inside ``serve.predict`` spans but outside
    ``serve.model`` spans, over the envelope: the card waiting on the entry
    layer's host work (packing, copies, read-back, counting)."""
    return idle_share(ctx, "serve.predict", "serve.model")


def launched_in(ctx, prefixes: Iterable[str]) -> List[dict]:
    """The sub-window's device events whose launch starts inside a span
    called by one of ``prefixes``, on that span's thread."""
    by_tid: Dict[object, List[Interval]] = {}
    for a, b, tid in spans(ctx, prefixes):
        by_tid.setdefault(tid, []).append((a, b))
    merged = {tid: merge(v) for tid, v in by_tid.items()}
    starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
    ids = set()
    for e in ctx.trace.events:
        if e.get("cat") not in LAUNCH_CATEGORIES or e.get("tid") not in merged:
            continue
        corr = (e.get("args") or {}).get("correlation")
        t = float(e["ts"])
        v = merged[e.get("tid")]
        i = bisect.bisect_right(starts[e.get("tid")], t) - 1
        if corr is not None and i >= 0 and t <= v[i][1]:
            ids.add(corr)
    if not ids:
        return []
    windows = _windows(ctx)
    out = []
    for e in ctx.trace.events:
        if e.get("cat") in xprof.DEVICE_CATEGORIES \
                and (e.get("args") or {}).get("correlation") in ids:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if any(lo <= a and b <= hi for lo, hi in windows):
                out.append(e)
    return out


def launched_device_ms_per_img(ctx, prefixes: Iterable[str]) -> Optional[float]:
    """Device ms per profiled image of the events ``launched_in`` the spans
    ``prefixes``: their union, overlaps counted once, so that disjoint sets
    of spans sum to at most ``readers.device_ms_per_img``."""
    if ctx.trace is None or not ctx.trace.images:
        return None
    found = launched_in(ctx, prefixes)
    busy = length(merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in found))
    return busy / 1e3 / len(ctx.trace.images) if busy > 0 else None


def real_px_pct(ctx) -> Optional[float]:
    """100 x ``serve.px_real`` / ``serve.px_bucket``: the share of the
    pixels in the buckets the backbone convolves that are the requests'
    own, over every ``pack_requests`` of the run (the program's counters;
    None for a program without them)."""
    try:
        from countdetr_tpu_torch.utils import trace
    except ImportError:
        return None
    counters = trace.counters()
    real, bucket = counters.get("serve.px_real", 0), counters.get("serve.px_bucket", 0)
    return 100.0 * real / bucket if real > 0 and bucket > 0 else None

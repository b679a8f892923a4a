"""request_p95_ms: the 95th percentile of every request's latency in the
window, from the call to its return on the host clock; a request that
failed counts as infinitely late (no number where that reaches the tail)."""

import math

from benchmark.yardstick.readers import percentile


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    p95 = percentile(lat, 95) * 1e3
    return p95 if math.isfinite(p95) else None

"""h2d_ms.serve: the mean ms of a predict call's `serve.h2d` span (the packed arrays copied to the card) in the profiled sub-window (benchmark/yardstick/spans.py::mean_span_ms)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean_span_ms(ctx, "serve.h2d")

"""pack_ms.serve: the mean ms of a predict call's ``serve.pack`` span (the requests padded, stacked, space-to-depth packed) in the profiled sub-window (benchmark/yardstick/spans.py::mean_span_ms)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean_span_ms(ctx, "serve.pack")

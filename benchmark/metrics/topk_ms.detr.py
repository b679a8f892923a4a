"""topk_ms.detr: the mean ms of a predict call's ``serve.topk`` span (the detector's top-100 post-processing on the card and its read-back, which waits for the forward) in the profiled sub-window (benchmark/yardstick/spans.py::mean_span_ms); None for a program without the span."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean_span_ms(ctx, "serve.topk")

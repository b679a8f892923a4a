"""model_issue_ms.single: the mean ms of a request's ``serve.model`` span, the host's time to issue one forward, in the profiled sub-window (benchmark/yardstick/spans.py::mean_span_ms)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean_span_ms(ctx, "serve.model")

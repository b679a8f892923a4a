"""model_issue_ms.pseudo: the mean ms of the ``model_forward`` range, the host's time to issue one stage-1 forward of a batch, in the profiled pass (benchmark/yardstick/spans.py::mean_span_ms). The range is the pseudo-label driver's own ``record_function`` around ``CountingDetr.forward`` (benchmark/drivers/pseudo_pass.py), on the profiler's host clock, not a span of the program's: ``generate_pseudo_labels`` has none yet."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.mean_span_ms(ctx, "model_forward")

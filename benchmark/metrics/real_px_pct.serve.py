"""real_px_pct.serve: the requests' own pixels, % of the bucket pixels the backbone convolves: the program's counters serve.px_real / serve.px_bucket (benchmark/yardstick/spans.py::real_px_pct)."""

from benchmark.yardstick.spans import real_px_pct as read  # noqa: F401

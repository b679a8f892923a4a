"""idle_pct.detr: the device's idle share of the profiled sub-window, % (benchmark/yardstick/readers.py::idle_pct)."""

from benchmark.yardstick.readers import idle_pct as read  # noqa: F401

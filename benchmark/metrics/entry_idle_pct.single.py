"""entry_idle_pct.single: the device's idle time inside ``serve.predict`` spans but outside ``serve.model`` spans, % of the envelope (benchmark/yardstick/spans.py::entry_idle_pct)."""

from benchmark.yardstick.spans import entry_idle_pct as read  # noqa: F401

"""device_ms_per_img.detr: busy device ms a detected image in the profiled sub-window (benchmark/yardstick/readers.py::device_ms_per_img)."""

from benchmark.yardstick.readers import device_ms_per_img as read  # noqa: F401

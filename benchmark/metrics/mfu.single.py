"""mfu.single: the window's model FLOPs over its seconds at the chip's peak, % (benchmark/yardstick/readers.py::mfu)."""

from benchmark.yardstick.readers import mfu as read  # noqa: F401

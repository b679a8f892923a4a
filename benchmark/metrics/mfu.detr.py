"""mfu.detr: the window's model FLOPs (each image at its own size, 300 positions x 3 patterns) over its seconds at the chip's peak, % (benchmark/yardstick/readers.py::mfu)."""

from benchmark.yardstick.readers import mfu as read  # noqa: F401

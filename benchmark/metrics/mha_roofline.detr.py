"""mha_roofline.detr: the MHA kernels' share of their roofline, % (benchmark/yardstick/readers.py::mha_roofline)."""

from benchmark.yardstick.readers import mha_roofline as read  # noqa: F401

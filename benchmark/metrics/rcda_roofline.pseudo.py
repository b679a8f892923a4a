"""rcda_roofline.pseudo: the RCDA kernels' share of their roofline, % (benchmark/yardstick/readers.py::rcda_roofline)."""

from benchmark.yardstick.readers import rcda_roofline as read  # noqa: F401

"""rcda_roofline.detr: the RCDA kernels' share of their roofline, %: the bound of the RCDA calls the profiled forwards need at the images' own sizes over the device time of the kernels named ``rcda_*`` (benchmark/yardstick/readers.py::rcda_roofline)."""

from benchmark.yardstick.readers import rcda_roofline as read  # noqa: F401

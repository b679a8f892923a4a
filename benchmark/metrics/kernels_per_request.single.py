"""kernels_per_request.single: device kernels a request in the profiled sub-window (benchmark/yardstick/readers.py::kernels_per_request)."""

from benchmark.yardstick.readers import kernels_per_request as read  # noqa: F401

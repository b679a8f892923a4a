"""backbone_device_ms.serve: device ms per image of the kernels and copies launched inside ``model.backbone`` spans, in the profiled sub-window (benchmark/yardstick/spans.py::launched_device_ms_per_img)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.launched_device_ms_per_img(ctx, ("model.backbone",))

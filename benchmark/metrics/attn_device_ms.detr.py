"""attn_device_ms.detr: device ms per image of the kernels and copies launched inside the attention cores' spans (``core.rcda``, ``core.mha``), the wrappers' helper kernels included, in the profiled sub-window (benchmark/yardstick/spans.py::launched_device_ms_per_img)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.launched_device_ms_per_img(ctx, ("core.rcda", "core.mha"))

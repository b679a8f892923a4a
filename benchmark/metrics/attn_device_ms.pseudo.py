"""attn_device_ms.pseudo: device ms per image of the kernels and copies launched inside the attention cores' spans (``core.rcda``, ``core.rcda_rank1``, ``core.mha``) of the stage-1 forwards over the point queries, the wrappers' helper kernels included, in the profiled pass (benchmark/yardstick/spans.py::launched_device_ms_per_img)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.launched_device_ms_per_img(ctx, ("core.rcda", "core.rcda_rank1", "core.mha"))

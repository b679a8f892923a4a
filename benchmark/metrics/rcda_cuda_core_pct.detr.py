"""rcda_cuda_core_pct.detr: the RCDA kernel launches of the run that took rcda.cu's CUDA-core kernel, % of all RCDA launches: the program's counters ``launch.rcda_cuda_cores`` over ``launch.rcda`` + ``launch.rcda_rank1`` (``countdetr_tpu_torch/utils/trace.py``). None for a program without the counter, which it sets, at 0 where none took that kernel, on every float32 launch."""


def read(ctx):
    try:
        from countdetr_tpu_torch.utils import trace
    except ImportError:
        return None
    counters = trace.counters()
    launches = counters.get("launch.rcda", 0) + counters.get("launch.rcda_rank1", 0)
    if "launch.rcda_cuda_cores" not in counters or launches <= 0:
        return None
    return 100.0 * counters["launch.rcda_cuda_cores"] / launches

"""The frozen copy of the program's trace readers reads what the program's
own readers read, and the busy union counts overlaps once."""

import pytest

from benchmark.yardstick import readers, xprof

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench_window", "ts": 0, "dur": 100, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 5, "dur": 20, "tid": 1},
    {"ph": "X", "cat": "kernel", "name": "void rcda_tf32_kernel<32>(CUtensorMap)", "ts": 10,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void mha_tf32_kernel<32>(CUtensorMap)", "ts": 15,
     "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 40,
     "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "cutlass_80_tensorop_s1688gemm", "ts": 60, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 5},
]


def test_copy_reads_what_the_program_reads():
    prog = pytest.importorskip("countdetr_tpu_torch.utils.xprof")
    for name in ("rcda_kernel", "void mha_tf32_kernel<32>", "nccl_all_reduce", "Memcpy HtoD",
                 "cutlass_80_tensorop", "cudnn::conv", "elementwise_kernel", "%fusion.12"):
        assert xprof.name_category(name) == prog.name_category(name)
    assert xprof.range_seconds(EVENTS, "bench_window") == prog.range_seconds(EVENTS, "bench_window")
    assert xprof.device_envelope_seconds(EVENTS, "bench_window") == \
        prog.device_envelope_seconds(EVENTS, "bench_window")
    assert xprof.op_table(EVENTS) == prog.op_table(EVENTS)


def test_busy_union_and_envelope():
    assert xprof.busy_intervals(EVENTS, "bench_window") == [(10, 25), (40, 45), (60, 80)]
    assert xprof.range_seconds(EVENTS, "bench_window") == pytest.approx(45e-6)
    assert xprof.device_envelope_seconds(EVENTS, "bench_window") == pytest.approx(70e-6)


def test_gap_labels_and_kernel_names():
    assert xprof._base("void rcda_tf32_kernel<32>(CUtensorMap)") == "rcda_tf32_kernel"
    assert xprof._base("void (anonymous namespace)::f32tc::mha_tf32_kernel<32>(int)") == \
        "mha_tf32_kernel"
    labels = readers._host_labels(EVENTS, 1, [7.0, 30.0, 52.0, 200.0])
    assert labels == ["aten::conv2d", "bench_window", "bench_window", None]

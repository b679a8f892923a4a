"""The port's device-time estimator (utils/xprof.py) and its LAP shim
(ops/lapjv.py) on the CPU.

xprof: ``name_category`` gives the JAX package's category on every XLA
instruction name both handle, and the CUDA categories on kernel names;
a Chrome-trace fixture (kernels, a copy, an NCCL all-reduce, a memset, CPU
ops and two calls of a record_function range, one kernel running past
the range's end) gives the table, total and range seconds computed by
hand; a real torch.profiler trace of a CPU run, written by
``export_chrome_trace`` as ``--profile`` writes it, gives the same table
from the file as from the live profiler (``events_from_profiler``) and
the CPU ops of its range.

lapjv: against the JAX package's shim and scipy, as tests/test_lapjv.py
holds the JAX one: square costs of 1 to 128 rows (the optimal total, a
permutation), a rectangular 30 x 80 cost, and a padded batch with a
partly and a wholly invalid image (each image's total optimal, invalid
slots 0; the same as JAX's ``solve_batch``); without the library, the
scipy route gives optimal totals too.
"""

import json

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from countdetr_tpu.ops import lapjv as jlapjv
from countdetr_tpu.utils import xprof as jxprof

from countdetr_tpu_torch.ops import lapjv
from countdetr_tpu_torch.utils import xprof

HLO_NAMES = ["%fusion.4433", "%loop_convolution_fusion.9", "%dot.12", "%while.1", "%copy.5",
             "%all-reduce.2", "%custom-call.7", "%reduce.3", "%convert.4", "%gemm_fusion.1",
             "%add.1 = f32[2]{0} add(f32[2]{0} %a, f32[2]{0} %b)", "fusion.12",
             "convolution.3", "dot.2", "copy-start.1", "reduce-window.3", "infeed.1",
             "outfeed", "convert.1", "transpose.9", "%input_reduce_fusion.3",
             "select-and-scatter.2", "%bitcast.2"]
CUDA_NAMES = {
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": "all-reduce",
    "Memcpy HtoD (Pageable -> Device)": "copy",
    "Memset (Device)": "memset",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "dot",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopB_TNN": "dot",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16>(Params)": "dot",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "convolution",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(int)": "convolution",
    "rcda_bf16_kernel": "custom-call",
    "rcda_rank1_kernel": "custom-call",
    "mha_wgmma_kernel": "custom-call",
    "auction_cluster_kernel": "custom-call",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(ReduceOp<float>)":
        "reduce",
    "void at::native::vectorized_elementwise_kernel<4, Add<float>>(int, Add<float>)":
        "elementwise",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, 4>(float*)":
        "CatArrayBatchedCopy",
    "void at::native::(anonymous namespace)::indexSelectSmallIndex<float, long>(int)":
        "indexSelectSmallIndex",
}


@pytest.mark.parametrize("name", HLO_NAMES)
def test_name_category_matches_jax_on_xla_names(name):
    assert xprof.name_category(name) == jxprof.name_category(name)


def test_name_category_of_cuda_kernels():
    assert {n: xprof.name_category(n) for n in CUDA_NAMES} == CUDA_NAMES


def fixture_events():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}

    return [
        x("step", "user_annotation", 100.0, 400.0),
        x("aten::mm", "cpu_op", 110.0, 20.0),
        x("sm90_xmma_gemm_bf16", "kernel", 150.0, 40.0),
        x("rcda_bf16_kernel", "kernel", 200.0, 100.0),
        x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 310.0, 5.0),
        x("ncclDevKernel_AllReduce_Sum_f32", "kernel", 320.0, 60.0),
        x("step", "user_annotation", 1000.0, 100.0),
        x("rcda_bf16_kernel", "kernel", 1010.0, 50.0),
        x("rcda_bf16_kernel", "kernel", 1080.0, 50.0),  # ends past the range
        x("Memset (Device)", "gpu_memset", 2000.0, 2.0),
        {"ph": "i", "name": "marker", "ts": 5.0},
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]


def test_parse_trace_of_a_fixture(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": fixture_events(), "schemaVersion": 1}))
    table, total = xprof.parse_trace(str(tmp_path))  # the newest trace under a directory
    assert table == {
        "sm90_xmma_gemm_bf16": [pytest.approx(40e-6), 1, "dot"],
        "rcda_bf16_kernel": [pytest.approx(200e-6), 3, "custom-call"],
        "Memcpy DtoH (Device -> Pinned)": [pytest.approx(5e-6), 1, "copy"],
        "ncclDevKernel_AllReduce_Sum_f32": [pytest.approx(60e-6), 1, "all-reduce"],
        "Memset (Device)": [pytest.approx(2e-6), 1, "memset"],
    }
    assert total == pytest.approx(307e-6)
    events = xprof.load_trace(str(path))
    assert xprof.range_seconds(events, "step") == pytest.approx((40 + 100 + 5 + 60 + 50) * 1e-6)
    assert xprof.range_seconds(events, "no such range") == 0.0
    assert xprof.range_seconds(events, "step", categories=("cpu_op",)) == pytest.approx(20e-6)


def test_parse_trace_of_a_cpu_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("three_products"):
            for _ in range(3):
                x @ x
        x + 1
    path = tmp_path / "profile" / "trace.json"
    path.parent.mkdir()
    prof.export_chrome_trace(str(path))
    cpu = ("cpu_op",)
    table, total = xprof.parse_trace(str(path), categories=cpu)
    live, live_total = xprof.op_table(xprof.events_from_profiler(prof), categories=cpu)
    assert set(table) == set(live) and table["aten::mm"][1] == 3 and table["aten::add"][1] == 1
    for name, (s, n, cat) in table.items():
        assert live[name][1] == n and live[name][2] == cat
        assert live[name][0] == pytest.approx(s, rel=1e-6, abs=1e-9)
    assert total == pytest.approx(live_total, rel=1e-6)
    raw = json.loads(path.read_text())["traceEvents"]
    rng = next(e for e in raw if e.get("name") == "three_products")
    want = sum(e["dur"] for e in raw if e.get("cat") == "cpu_op"
               and rng["ts"] <= e["ts"] and e["ts"] + e["dur"] <= rng["ts"] + rng["dur"])
    events = xprof.load_trace(str(path))
    assert xprof.range_seconds(events, "three_products", categories=cpu) == pytest.approx(
        want * 1e-6)
    assert 0 < want < sum(e["dur"] for e in raw if e.get("cat") == "cpu_op")  # the add is out
    assert xprof.op_table(events)[1] == 0.0  # no device work on the CPU


# ---------------------------------------------------------------- lapjv


@pytest.fixture(scope="module")
def shims():
    assert lapjv.available()  # c++ is on this machine
    assert lapjv.library_path().exists() and lapjv.library_path().parent.name == "_build"
    return lapjv, jlapjv


def test_lapjv_square_matches_scipy_and_jax(shims, rng):
    for n in (1, 5, 40, 128):
        cost = rng.normal(size=(n, n)).astype(np.float32) * 7
        cols, total = lapjv.solve(cost)
        jcols, jtotal = jlapjv.solve(cost)
        r, c = linear_sum_assignment(cost)
        assert cols.dtype == np.int32 and sorted(cols.tolist()) == list(range(n))
        np.testing.assert_allclose(total, cost[r, c].sum(), rtol=1e-5)
        np.testing.assert_array_equal(cols, jcols)
        np.testing.assert_allclose(total, jtotal, rtol=1e-6)


def test_lapjv_rectangular(shims, rng):
    cost = rng.normal(size=(30, 80)).astype(np.float32) * 3
    cols, total = lapjv.solve(cost)
    r, c = linear_sum_assignment(cost)
    np.testing.assert_allclose(total, cost[r, c].sum(), rtol=1e-5)
    np.testing.assert_allclose(cost[np.arange(30), cols].sum(), total, rtol=1e-6)
    np.testing.assert_array_equal(cols, jlapjv.solve(cost)[0])
    with pytest.raises(ValueError, match="rows <= columns"):
        lapjv.solve(cost.T)


def test_lapjv_batch_padded(shims, rng):
    B, Q, T = 3, 50, 30
    cost = rng.normal(size=(B, Q, T)).astype(np.float32) * 4
    valid = np.ones((B, T), dtype=bool)
    valid[1, 10:] = False
    valid[2, :] = False
    out = lapjv.solve_batch(cost, valid)
    np.testing.assert_array_equal(out, jlapjv.solve_batch(cost, valid))
    for b in range(B):
        t_idx = np.nonzero(valid[b])[0]
        if len(t_idx) == 0:
            assert (out[b] == 0).all()
            continue
        r, c = linear_sum_assignment(cost[b][:, t_idx])
        opt = cost[b][:, t_idx][r, c].sum()
        ours = sum(cost[b][out[b, t], t] for t in t_idx)
        np.testing.assert_allclose(ours, opt, rtol=1e-5)
        assert len(set(out[b, t_idx].tolist())) == len(t_idx)


def test_lapjv_falls_back_to_scipy_without_a_library(monkeypatch, rng):
    monkeypatch.setattr(lapjv, "_load", lambda: None)
    cost = rng.normal(size=(3, 40, 20)).astype(np.float32)
    valid = np.ones((3, 20), bool)
    valid[0, 5:] = False
    out = lapjv.solve_batch(cost, valid)
    assert out.dtype == np.int32 and (out[0, 5:] == 0).all()
    for b in range(3):
        t_idx = np.nonzero(valid[b])[0]
        r, c = linear_sum_assignment(cost[b][:, t_idx])
        np.testing.assert_allclose(sum(cost[b][out[b, t], t] for t in t_idx),
                                   cost[b][:, t_idx][r, c].sum(), rtol=1e-6)
    cols, total = lapjv.solve(cost[1, :20])
    r, c = linear_sum_assignment(cost[1, :20])
    np.testing.assert_allclose(total, cost[1, :20][r, c].sum(), rtol=1e-6)
    np.testing.assert_array_equal(cols[r], c)

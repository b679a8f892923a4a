"""The port's serving bench (countdetr_tpu_torch/bench.py) and its
device-time table (countdetr_tpu_torch/cli/profile_eval.py) against the JAX
package's root ``bench.py`` and ``scripts/profile_eval.py``, on the CPU.

- The inputs: ``bench_inputs`` builds the root bench's arrays byte for byte
  (the same numpy seed, the JAX package's ``pack_space_to_depth``).
- The forward: the bench's model and loop on the CPU (the kernels' plain
  versions) against JAX's ``CountingDetr.apply`` on the same inputs, packed
  uint8 and unpacked float32, at B=2, 128x128, 1+1 layers, hidden 32, 4
  heads. The JAX params come from ``jax.eval_shape`` filled from a numpy
  seed (tests/test_torch_longtail.py) and go to the port through
  ``params_from_jax``; 1e-4 (atol and rtol), the tolerance of
  tests/test_torch_model.py.
- ``utils/xprof.py::device_envelope_seconds`` on synthetic event lists:
  first to last device event of each call of the range, gaps included;
  events straddling the range's edges left out; 0.0 without the range.
- ``main`` on the CPU with BENCH_PROFILE=0 prints the JAX bench's line with
  ``device`` last; the refusals (BENCH_PALLAS=0, BENCH_PROFILE=1 off the
  card, a missing card, a profiler range with no device event) exit
  non-zero and print no result.
- ``profile_eval --parse_only`` on a canned Chrome trace: the sums by
  category, the top ops' order, the range's envelope, the annotation kept
  out of the total, and the summary JSON's keys equal to the JAX script's.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu import config as jcfg
from countdetr_tpu.data.batching import pack_space_to_depth as jax_pack
from countdetr_tpu.models import CountingDetr as JaxCountingDetr

from countdetr_tpu_torch import bench
from countdetr_tpu_torch.cli import profile_eval
from countdetr_tpu_torch.config import stage2_config
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.utils import xprof
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_longtail import fill_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=32, nheads=4, dim_feedforward=64,
            num_query_position=25)
TOL = 1e-4
SIZE = 128
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread spares them the thread pool's cost
    while the suite's other workers hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def root_bench_arrays(B, H, W, packed):
    """The arrays of the root bench.py (its lines building images, pad_mask
    and rects), in numpy."""
    rng = np.random.default_rng(0)
    if packed:
        images = jax_pack(rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8))
    else:
        images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    pad_mask = np.zeros((B, H, W), dtype=bool)
    rects = np.tile(np.array([[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6],
                              [0.2, 0.5, 0.4, 0.7]], np.float32)[None], (B, 1, 1))
    return images, pad_mask, rects


@pytest.mark.parametrize("packed", [True, False])
def test_bench_inputs_equal_the_root_bench(packed):
    got = bench.bench_inputs(2, 592, packed=packed)
    want = root_bench_arrays(2, 592, 592, packed)
    shapes = [(2, 296, 296, 12) if packed else (2, 592, 592, 3), (2, 592, 592), (2, 3, 4)]
    for g, w, shape in zip(got, want, shapes):
        assert g.dtype == w.dtype and g.shape == w.shape == shape
        assert g.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def jax_pair():
    jc = jcfg.stage2_config().model.replace(**TINY)
    model = JaxCountingDetr(jc)
    images, mask, rects = bench.bench_inputs(2, SIZE)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(mask), exemplar_boxes=jnp.asarray(rects))
    return jax.jit(model.apply), fill_params(shapes, 12)


@pytest.mark.parametrize("packed", [True, False])
def test_bench_forward_matches_jax(jax_pair, packed):
    """The bench's model and forward loop on the CPU against JAX's apply on
    the same inputs and weights (uint8 packed, and float32 unpacked: the
    float images go to the 3-channel stem without the uint8 normalise)."""
    apply, params = jax_pair
    arrays = bench.bench_inputs(2, SIZE, packed=packed)
    images, mask, rects = arrays
    want = apply(params, jnp.asarray(images), jnp.asarray(mask),
                 exemplar_boxes=jnp.asarray(rects))
    model = build_model(stage2_config(**TINY), "cpu", state_dict=params_from_jax(params))
    got = bench.forwards(model, tuple(torch.from_numpy(a) for a in arrays), 1,
                         torch.device("cpu"))
    for key in ("pred_logits", "pred_boxes", "pred_vars"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=key)


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def envelope_events():
    """Two calls of bench_loop (100-1100 and 2000-2500 us) with gaps between
    their kernels, a warm-up kernel straddling the first call's start, a
    kernel running past its end, and work outside both."""
    return [
        ev("bench_loop", "user_annotation", 100.0, 1000.0),
        ev("warm_kernel", "kernel", 50.0, 80.0),  # queued before the range opened
        ev("aten::mm", "cpu_op", 150.0, 5.0),
        ev("rcda_wgmma_kernel", "kernel", 200.0, 100.0),
        ev("mha_wgmma_kernel", "kernel", 500.0, 50.0),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 700.0, 10.0),
        ev("late_kernel", "kernel", 1050.0, 100.0),  # still running at the range's end
        ev("bench_loop", "gpu_user_annotation", 200.0, 510.0),
        ev("bench_loop", "user_annotation", 2000.0, 500.0),
        ev("rcda_wgmma_kernel", "kernel", 2100.0, 100.0),
        ev("Memset (Device)", "gpu_memset", 2300.0, 100.0),
        ev("bench_loop", "gpu_user_annotation", 2100.0, 300.0),
        ev("outside_kernel", "kernel", 3000.0, 10.0),
    ]


def test_device_envelope_counts_gaps_and_leaves_out_the_edges():
    events = envelope_events()
    # first call 200 -> 710 us, second 2100 -> 2400 us; the straddling
    # kernels, the CPU op and the kernel outside both calls are out
    env = xprof.device_envelope_seconds(events, "bench_loop")
    assert env == pytest.approx((510 + 300) * 1e-6)
    busy = xprof.range_seconds(events, "bench_loop")
    assert busy == pytest.approx((100 + 50 + 10 + 100 + 100) * 1e-6)
    assert env >= busy
    assert xprof.annotation_seconds(events, "bench_loop") == pytest.approx(env)
    assert xprof.device_envelope_seconds(events, "no such range") == 0.0
    assert xprof.annotation_seconds(events, "no such range") == 0.0
    # one call alone
    one = [e for e in events if e["ts"] < 1500]
    assert xprof.device_envelope_seconds(one, "bench_loop") == pytest.approx(510e-6)


def test_device_envelope_needs_the_synchronizes():
    """A range closed before its kernels ran holds none of them (0.0: the
    bench then fails); a kernel queued before the range opened that starts
    inside it is counted, which the synchronize before the range prevents."""
    unsynced_end = [ev("bench_loop", "user_annotation", 0.0, 100.0),
                    ev("rcda_wgmma_kernel", "kernel", 90.0, 200.0)]
    assert xprof.device_envelope_seconds(unsynced_end, "bench_loop") == 0.0
    leaked = [ev("bench_loop", "user_annotation", 0.0, 1000.0),
              ev("warm_kernel", "kernel", 10.0, 300.0),  # queued before the range
              ev("rcda_wgmma_kernel", "kernel", 600.0, 100.0)]
    assert xprof.device_envelope_seconds(leaked, "bench_loop") == pytest.approx(690e-6)
    assert xprof.device_envelope_seconds(leaked[::2], "bench_loop") == pytest.approx(100e-6)


def tiny_env(**kw):
    env = {"BENCH_DEVICE": "cpu", "BENCH_PROFILE": "0", "BENCH_BATCH": "1", "BENCH_ITERS": "4",
           "BENCH_PAIRS": "2", "BENCH_DTYPE": "float32"}
    env.update(kw)
    return env


@pytest.mark.parametrize("packed", ["1", "0"])
def test_main_prints_the_root_bench_line(capsys, packed):
    assert bench.main(tiny_env(BENCH_PACKED=packed), model_cfg=stage2_config(**TINY),
                      size=64) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == RESULT_KEYS
    assert last["metric"] == "images/sec/chip at 600px eval (stage-2 forward)"
    assert last["unit"] == "img/s/chip" and last["device"] == "cpu"
    assert np.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 19.0, 2)
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["estimator"] in ("two_point", "single_point")
    assert stats["wall_img_per_s"] == pytest.approx(last["value"], abs=0.005)
    assert stats["device_profile_img_per_s"] is None  # no profile off the card
    assert stats["packed"] == (packed == "1") and stats["lo"] == 1 and stats["hi"] == 4
    assert stats["forwards"] == 2 * (1 + 4)  # the pairs after the warm runs
    assert stats["launches"] == {"rcda": 0, "rcda_rank1": 0, "mha": 0, "auction": 0,
                                 "pack": 0}


@pytest.mark.parametrize("env,raises,match", [
    (tiny_env(BENCH_PALLAS="0"), SystemExit, "BENCH_PALLAS=0"),
    (tiny_env(BENCH_PROFILE="1"), SystemExit, "BENCH_PROFILE=1"),
    (tiny_env(BENCH_DEVICE="cuda"), RuntimeError, "CUDA is not available"),
    (tiny_env(BENCH_PACKED="2"), SystemExit, "BENCH_PACKED"),
])
def test_refusals_fail_loudly(capsys, monkeypatch, env, raises, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(raises, match=match):
        bench.main(env, model_cfg=stage2_config(**TINY), size=64)
    assert capsys.readouterr().out == ""


def test_a_profile_without_device_events_fails(capsys, monkeypatch):
    """No fallback to the wall clock: a bench_loop range holding no device
    event ends the run with no result line."""
    knobs = bench.read_knobs(tiny_env())
    monkeypatch.setattr(bench, "read_knobs", lambda env: dict(knobs, profile=True))
    monkeypatch.setattr(bench, "profiled_loop", lambda *a: {
        "envelope_s": 0.0, "busy_s": 0.0, "annotation_s": 0.0, "wall_s": 1.0, "parse_s": 0.0})
    with pytest.raises(SystemExit, match="no device event"):
        bench.main(tiny_env(), model_cfg=stage2_config(**TINY), size=64)
    assert capsys.readouterr().out == ""


def test_profiled_loop_reads_its_range_from_the_trace():
    """The profiled range goes through the exported Chrome trace; on the CPU
    it holds no device event, so every device number is 0.0 (which main
    refuses: the profile runs only on the card)."""
    model = build_model(stage2_config(**TINY), "cpu")
    inputs = tuple(torch.from_numpy(a) for a in bench.bench_inputs(1, 64))
    got = bench.profiled_loop(model, inputs, 2, torch.device("cpu"))
    assert got["envelope_s"] == got["busy_s"] == got["annotation_s"] == 0.0
    assert got["wall_s"] > 0 and got["parse_s"] >= 0


def test_script_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "countdetr_tpu_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA is not available" in res.stderr


def jax_summary_keys():
    """The keys of the summary JSON that scripts/profile_eval.py writes (the
    dict passed to json.dump in its main)."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "profile_eval.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dump"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dump of a dict in scripts/profile_eval.py")


def canned_trace():
    """One bench_loop call (1000-2000 us) of 2 forwards' kernels, a warm-up
    kernel before it, a kernel past its end, CPU ops and the range's
    annotations."""
    return [
        ev("bench_loop", "user_annotation", 1000.0, 1000.0),
        ev("bench_loop", "gpu_user_annotation", 1010.0, 980.0),
        ev("aten::conv2d", "cpu_op", 1001.0, 30.0),
        ev("void at::native::reduce_kernel<512, 1>(float)", "kernel", 500.0, 40.0),
        ev("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel",
           1010.0, 300.0),
        ev("void rcda_wgmma_kernel<32>(CUtensorMap, float*)", "kernel", 1320.0, 120.0),
        ev("mha_wgmma_kernel", "kernel", 1450.0, 60.0),
        ev("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "kernel",
           1520.0, 90.0),
        ev("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>(int)",
           "kernel", 1620.0, 30.0),
        ev("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>(int)",
           "kernel", 1660.0, 20.0),
        ev("void rcda_wgmma_kernel<32>(CUtensorMap, float*)", "kernel", 1700.0, 110.0),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1850.0, 10.0),
        ev("mha_wgmma_kernel", "kernel", 1950.0, 100.0),  # ends past the range
    ]


def test_profile_eval_parse_only_on_a_canned_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    (trace_dir / "t.json").write_text(json.dumps({"traceEvents": canned_trace()}))
    summary_path = tmp_path / "summary.json"
    profile_eval.main(["--parse_only", "--trace_dir", str(trace_dir), "--iters", "2",
                       "--batch", "4", "--summary", str(summary_path)])
    out = capsys.readouterr().out
    summary = json.loads(summary_path.read_text())
    assert set(summary) == jax_summary_keys()
    assert summary["iters"] == 2 and summary["batch"] == 4 and summary["packed"] is True
    # every kernel, copy and memset of the trace; neither annotation
    assert summary["total_s"] == pytest.approx(
        (40 + 300 + 120 + 60 + 90 + 30 + 20 + 110 + 10 + 100) * 1e-6)
    want = {"reduce": 40, "convolution": 300, "custom-call": 120 + 60 + 110 + 100,
            "dot": 90, "elementwise": 50, "copy": 10}
    assert summary["by_category"] == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert [op["name"][:12] for op in summary["top_ops"]] == [
        "sm90_xmma_fp", "void rcda_wg", "mha_wgmma_ke", "sm90_xmma_ge", "void at::nat",
        "void at::nat", "Memcpy DtoH "]
    assert [op["count"] for op in summary["top_ops"]][:3] == [1, 2, 2]
    assert summary["top_ops"][4]["category"] == "elementwise"
    # first kernel inside the range at 1010, last ending inside at 1860
    assert summary["while_envelope_s"] == pytest.approx(850e-6)
    assert "ms/forward @ B=4" in out and "gpu_user_annotation span 0.98 ms" in out


def test_profile_eval_capture_on_the_cpu(tmp_path):
    """The capture writes a Chrome trace holding the bench_loop range; on the
    CPU it has no device op, so the table is empty."""
    path = profile_eval.capture(str(tmp_path), 1, 2, "float32", True, "cpu",
                                model_cfg=stage2_config(**TINY), size=64)
    events = xprof.load_trace(path)
    ranges = [e for e in events if e["name"] == "bench_loop"]
    assert [e["cat"] for e in ranges] == ["user_annotation"]
    summary = profile_eval.summarize(events, 2, 1, True)
    assert summary["total_s"] == 0.0 and summary["by_category"] == {}
    assert summary["while_envelope_s"] == 0.0

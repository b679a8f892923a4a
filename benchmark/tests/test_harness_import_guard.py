"""No JAX in the benchmark: the reference, run in a fresh process, loads no
module whose top-level name (compared whole) is jax, jaxlib, flax, the JAX
package or the program; a whole run of a cell loads none but the program."""

import json
import subprocess
import sys

from benchmark import harness

ROOT = str(harness.ROOT)
REFERENCE_RUN = """
import json, sys
import numpy as np
from benchmark.reference import counting, model, weights
m = {"stage": 2, "hidden_dim": 32, "nheads": 4, "enc_layers": 1, "dec_layers": 1,
     "dim_feedforward": 64, "num_query_position": 16, "num_query_pattern": 1, "num_classes": 2,
     "with_variance_head": True, "spatial_prior": "grid"}
p = weights.draw(m, {"cls_logit_std": 1.0, "cls_bias": -4.6}, 1, "cpu")
img = np.zeros((64, 64, 3), np.uint8)
out = model.run(p, m, [{"image": img, "exemplars": np.full((3, 4), 0.3, np.float32),
                        "bucket": (64, 96)}], "cpu")
counting.served(out[0]["pred_logits"][None], out[0]["pred_boxes"][None], [(64, 64)])
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""

CELL_RUN = """
import json, sys, time
from benchmark import harness
from benchmark.tests.tiny import CELLS
harness.run_cell("s2_serve_b1", 11, 0.2, False, time.perf_counter(), device="cpu",
                 overrides=CELLS["s2_serve_b1"])
print(json.dumps(harness.forbidden_loaded()))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_neither_jax_nor_the_program():
    tops = set(_run(REFERENCE_RUN))
    assert not tops & {"jax", "jaxlib", "flax", "countdetr_tpu", "countdetr_tpu_torch"}, tops


def test_a_run_loads_no_jax():
    assert _run(CELL_RUN) == []


def test_names_compare_whole():
    assert harness.forbidden_loaded(["countdetr_tpu_torch", "countdetr_tpu_torch.serve",
                                     "jaxtyping", "flaxen", "torch"]) == []
    assert harness.forbidden_loaded(["jaxlib.xla_client", "countdetr_tpu.models", "flax"]) == \
        ["countdetr_tpu", "flax", "jaxlib"]

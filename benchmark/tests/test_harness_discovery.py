"""A later cell, configuration, mix and metrics come as new files and new
manifest entries: in a temporary copy of the benchmark, files for a dummy
cell are added, no file there is edited, and the harness finds and runs
them by their names."""

import json
import shutil
import time

from benchmark import harness
from benchmark.tests.tiny import CELLS

GENERATOR = '''
def generate(mix, seed, device):
    return {"items": list(range(mix["items"])), "seed": seed}
'''
DRIVER = '''
from benchmark.harness import Check, Window


class Driver:
    def __init__(self, cfg, mix, cell, traffic, seed, device):
        self.traffic, self.cell = traffic, cell

    def setup(self):
        pass

    def window(self, seconds):
        n = len(self.traffic["items"])
        return Window(seconds=1.0, attempted=n, images=[(64, 64, 0)] * n)

    def profiled(self):
        return [(64, 64, 0)], 1

    def release(self):
        pass

    def compare(self):
        return [Check("dummy_gap", 0.0, self.cell["check"]["limits"]["dummy_gap"])]
'''
E2E = '''
def read(ctx):
    return float(ctx.window.attempted) / ctx.window.seconds
'''
LAYER = '''
def read(ctx):
    return None if ctx.trace is None else float(ctx.trace.requests)
'''


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    (b / "generators" / "dummy_gen.py").write_text(GENERATOR)
    (b / "drivers" / "dummy_driver.py").write_text(DRIVER)
    (b / "metrics" / "dummy_rate.py").write_text(E2E)
    (b / "metrics" / "dummy_layer.x.py").write_text(LAYER)
    cfg = json.loads((b / "configs" / "stage2_fscd147_f32.json").read_text())
    cfg["name"] = "dummy_config"
    (b / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps({"generator": "dummy_gen",
                                                              "items": 5}))
    (b / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"driver": "dummy_driver", "check": {"limits": {"dummy_gap": 0.0}}}))
    man["configs"].append({"name": "dummy_config", "source": "https://example.org",
                           "file": "benchmark/configs/dummy_config.json", "reduced": [],
                           "why": "a dummy"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                             "traffic": "dummy_mix", "chips": 1, "why": "a dummy"})
    man["end_to_end"].append({"name": "dummy_rate", "unit": "items/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["dummy_cell"]})
    man["per_layer"].append({"name": "dummy_layer.x", "unit": "requests", "better": "higher",
                             "source": "device_trace", "layer": "entry",
                             "moves": "dummy_rate"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    res = harness.run_cell("dummy_cell", 3, 0.1, False, time.perf_counter(), device="cpu",
                           root=root)
    assert res["correct"] is True and res["attempted"] == 5
    assert set(res["metrics"]) == {"setup_s", "dummy_rate"}
    assert res["metrics"]["dummy_rate"] == {"value": 5.0, "unit": "items/s"}
    traced = harness.run_cell("dummy_cell", 3, 0.1, True, time.perf_counter(), device="cpu",
                              root=root)
    assert traced["metrics"] == {"dummy_layer.x": {"value": 1.0, "unit": "requests"}}
    # an existing cell still runs from the copy, and no existing file changed
    res = harness.run_cell("s2_serve_b1", 3, 0.2, False, time.perf_counter(), device="cpu",
                           root=root, overrides=CELLS["s2_serve_b1"])
    assert res["correct"] is True and "request_p95_ms" in res["metrics"]
    for rel, body in before.items():
        assert (root / rel).read_bytes() == body

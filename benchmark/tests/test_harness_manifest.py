"""BENCHMARK.json against the benchmark's contract: its keys, the character
rules of names and units, and every file that an entry names; and every
cell, configuration, mix and metric file under ``benchmark/`` named by the
manifest, so that none is parked beside it."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = harness.manifest()
ROOT = harness.ROOT


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_legal(group):
    names = [e["name"] for e in MAN[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_entries():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_and_cells():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["why"]) and line(c["source"]) and c["file"].startswith("benchmark/")
        assert os.path.isfile(ROOT / c["file"]) and len(c["reduced"]) <= 16
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e, layer = harness.cell_metrics(MAN, cell)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
    for m in e2e + layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_resolve(cell):
    entry = harness.find_cell(MAN, cell)
    mix = harness.load_json(ROOT / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    spec = harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json")
    assert (ROOT / "benchmark" / "generators" / f"{mix['generator']}.py").is_file()
    assert (ROOT / "benchmark" / "drivers" / f"{spec['driver']}.py").is_file()
    assert spec["check"]["limits"] and all(v >= 0 for v in spec["check"]["limits"].values())


def test_file_names_under_paths():
    for path in MAN["paths"]:
        for dirpath, dirnames, files in os.walk(ROOT / path):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel


# for each folder, the manifest's names that a file there must be one of
NAMED = {
    "workloads": {w["name"] for w in MAN["workloads"]},
    "configs": {c["file"] for c in MAN["configs"]},
    "traffic": {w["traffic"] for w in MAN["workloads"]},
    "metrics": {m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]},
}
ON_DISK = sorted((folder, path.name) for folder, suffix in
                 (("workloads", ".json"), ("configs", ".json"), ("traffic", ".json"),
                  ("metrics", ".py"))
                 for path in (harness.BENCH / folder).glob("*" + suffix))


@pytest.mark.parametrize("folder,file", ON_DISK)
def test_every_file_is_in_the_manifest(folder, file):
    """A cell, configuration, mix or metric comes into the benchmark by its
    manifest entry; a file that no entry names is a cell kept off the
    checks."""
    want = f"benchmark/{folder}/{file}" if folder == "configs" else file.rsplit(".", 1)[0]
    assert want in NAMED[folder], f"benchmark/{folder}/{file} is named by no manifest entry"

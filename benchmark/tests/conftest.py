"""The benchmark's own tests: ``python -m pytest benchmark/tests`` on the
CPU; those marked ``chip`` need a CUDA card and skip without one (run them
on the card with ``python -m pytest benchmark/tests -m chip``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def pseudo_root(tmp_path_factory):
    """A checkout whose manifest adds the stage-1 pseudo-labelling cell,
    which BENCHMARK.json leaves out (its host-bound rate spread more than
    any bound allows; PERF.md, Open questions): the benchmark's folder by a
    link, BENCHMARK.json with the cell's entries from ``pseudo_cell.json``."""
    import json

    from benchmark import harness

    root = tmp_path_factory.mktemp("pseudo_checkout")
    (root / "benchmark").symlink_to(harness.BENCH, target_is_directory=True)
    man = harness.manifest()
    for key, entries in harness.load_json(harness.BENCH / "tests" / "pseudo_cell.json").items():
        man[key] = man[key] + entries
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root

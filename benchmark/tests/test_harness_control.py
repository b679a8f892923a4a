"""The control, on the card at each cell's own size: the program's
bfloat16 path in place of the float32 that the configuration states,
judged by the cell's own check, comes out not correct on three seeds."""

import pytest

from benchmark import harness
from benchmark.limits import readings


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_is_not_correct(cell, card):
    for seed, res in readings(cell, [4_200_000_001, 4_200_000_002, 4_200_000_003], True, 3.0,
                              device=card):
        assert res["correct"] is False, (seed, res["check"])

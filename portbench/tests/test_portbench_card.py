"""On the card, at each cell's own size: the control (the reference in
bfloat16 put in the program's place) fails the cell's comparison on three
seeds, and the program passes it on the same frames.

    python -m pytest portbench/tests -m card
"""

import json

import pytest
from conftest import REPO

from portbench import check, harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("seed", [3200000001, 3200000002, 3200000003])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell, seed):
    c = harness.Cell(cell, seed, card)
    r = c.readings(control=True)
    sound, checks = check.judge(r["program"], c.workload["limits"])
    assert sound, checks
    control, checks = check.judge(r["control"], c.workload["limits"])
    assert not control, checks

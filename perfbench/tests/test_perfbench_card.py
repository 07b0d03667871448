"""On the card, at each cell's own size: the program passes its limits, and
the control (the reference in the program's place, one precision down) and
the half-batch fault do not.

    python -m pytest perfbench/tests/test_perfbench_card.py   # on a machine with a card

Each test takes one cell's set-up and check (no measured window for a
training cell, a short one for the scoring cell) on one seed."""

from __future__ import annotations

import pytest

from perfbench import calibrate, harness

CELLS = [w["name"] for w in harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
         ["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[n] > limit for n, limit in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_the_control_and_the_fault_fail(name, card):
    cell = harness.load_cell(name)
    limits = cell.spec["limits"]
    out = calibrate.readings(cell, 2 ** 31 + 977, True, card)
    assert not _fails(out["program"], limits), out
    assert _fails(out["control"], limits), out
    assert _fails(out["half_batch"], limits), out

"""On the card: a run of the cell at its own size with a short window is
correct, and its control (the reference at the next lower precision in the
program's place, at the same inputs) fails at least one of the cell's
limits. Skips without a card:

    python -m pytest -p no:cacheprovider port_bench/tests/test_port_bench_card.py
"""

import time

import pytest

from port_bench.harness.cells import Cell
from port_bench.harness.runner import run_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["deeponet-row-top2048"])
def test_control_fails_and_the_program_passes(card, cell):
    out = run_cell(cell, 918273645, 5.0, False, card, time.perf_counter(), control=True)
    assert out["line"]["correct"] is True, out["line"]["checks"]
    limits = Cell(cell).workload["limits"]
    failed = [k for k, v in out["control"].items() if k in limits and v > limits[k]]
    assert failed, out["control"]

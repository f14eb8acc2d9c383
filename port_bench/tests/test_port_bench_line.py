"""The result line's schema, from a run on the CPU at a small size (the
harness's look for a card skipped), and the entry's refusal without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench.harness.cells import ROOT, Cell
from port_bench.harness.runner import run_cell
from port_bench.tests.conftest import SMALL


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_line_schema(cell, trace):
    co, wo = SMALL[cell]
    line = run_cell(cell, 2 ** 31 + 17, 0.5, bool(trace), "cpu", time.perf_counter(), co,
                    wo)["line"]
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = Cell(cell)
    want = {m["name"] for m in (c.per_layer() if trace else c.end_to_end())}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def test_no_jax_in_the_process_after_a_run():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, time; sys.path.insert(0, %r)\n"
         "from port_bench.harness.runner import run_cell, jax_modules\n"
         "from port_bench.tests.conftest import SMALL\n"
         "co, wo = SMALL['deeponet-row-top2048']\n"
         "run_cell('deeponet-row-top2048', 5, 0.2, False, 'cpu', time.perf_counter(), co, wo)\n"
         "print(jax_modules())" % ROOT],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_without_a_card_exits_non_zero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "deeponet-row-top2048",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""

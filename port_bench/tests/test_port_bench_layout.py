"""BENCHMARK.json against its contract, and every name it holds resolved to
its file."""

import json
import os
import re

import pytest

from port_bench.harness.cells import ROOT, Cell, load_benchmark, load_module, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load_benchmark()


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=[f"{k}:{e['name']}" for k, e in _entries()])
def test_entry_keys_and_names(key, entry):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[key]
    assert set(entry) <= allowed
    assert NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry and key in ("configs", "workloads", "per_layer"):
            v = entry[text]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_unique_and_cells_well_formed():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        assert layers.setdefault(m["layer"], m["layer"]) == m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = Cell(cell)
    assert callable(c.system().build)
    assert hasattr(c.reference(), "Reference")
    w = c.workload
    assert set(w["limits"]) >= {"lp_gap_nats", "field_gap", "unmoved_chains_pct"}
    assert w["window"]["burn_segments"] >= 1
    assert w["window"]["segment"] % w["window"]["thin"] == 0
    e2e = [m["name"] for m in c.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_resolves_to_its_reader(metric):
    assert callable(metric_reader(metric))
    for cell in [m for m in BENCH["per_layer"] if m["name"] == metric][0].get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_loader_names_modules_by_path():
    a = load_module("port_bench/metrics/mfu_pct.py")
    assert load_module("port_bench/metrics/mfu_pct.py") is a

"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, cell or per-layer metric is a
file of its own, found by name:

* ``configs/<config>.json``: the model, the data and the posterior;
* ``systems/<config>.py``: ``build(config, workload, seed, device)``, the
  system under test composed from the program's own functions;
* ``reference/<config>.py``: ``Reference``, the plain PyTorch reference;
* ``workloads/<cell>.json``: the cell's recipe, window and limits;
* ``metrics/<metric>.py``: ``read(ctx)``, one per-layer metric.

A later cell, configuration or metric is new files plus new entries.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_module(rel: str):
    """The Python file ``rel`` (relative to the checkout) as a module; names
    may hold ``-`` and ``.``, so the file is loaded by path."""
    path = os.path.join(ROOT, rel)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{rel} is missing")
    mod_name = "port_bench_" + rel.replace("/", "_").replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One entry of ``workloads`` with its files."""

    def __init__(self, name: str, config_over=None, workload_over=None):
        self.bench = load_benchmark()
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.config_name = self.entry["config"]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.config_name]
        self.config = merged(load_json(self.config_entry["file"]), config_over)
        self.workload = merged(load_json(f"port_bench/workloads/{self.entry['traffic']}.json"),
                               workload_over)

    def system(self):
        return load_module(f"port_bench/systems/{self.config_name}.py")

    def reference(self):
        return load_module(f"port_bench/reference/{self.config_name}.py")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]


def metric_reader(name: str):
    return load_module(f"port_bench/metrics/{name}.py").read

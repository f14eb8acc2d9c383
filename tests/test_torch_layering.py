"""The port's layering: ``vihmc_torch/core`` imports nothing above it.

Every module under ``vihmc_torch/core/`` is parsed, imports inside functions
included; an import of any part of ``vihmc_torch`` outside ``core`` (``ops``,
``hmc``, ``models``, ...) fails, so a new kernel or a new model's spans edit
no file of ``core``.
"""

from __future__ import annotations

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORE = sorted(glob.glob(os.path.join(ROOT, "vihmc_torch", "core", "*.py")))


def _imports(source: str, package: str = "vihmc_torch.core") -> list:
    """``(line, dotted name)`` of every import in ``source``, at any depth;
    relative imports resolved against ``package``, ``from a import b`` read
    as ``a.b``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out += [(node.lineno, f"{base}.{a.name}") for a in node.names]
    return out


def _upward(source: str) -> list:
    return [(line, name) for line, name in _imports(source)
            if (name == "vihmc_torch" or name.startswith("vihmc_torch."))
            and not (name + ".").startswith("vihmc_torch.core.")]


@pytest.mark.parametrize("path", CORE, ids=[os.path.basename(p) for p in CORE])
def test_core_imports_nothing_above_it(path):
    with open(path) as f:
        assert _upward(f.read()) == [], path


@pytest.mark.parametrize("source,upward", [
    ("def f():\n    from vihmc_torch.ops.deeponet_merge import merge_sums\n",
     [(2, "vihmc_torch.ops.deeponet_merge.merge_sums")]),
    ("from vihmc_torch import hmc, core\n", [(1, "vihmc_torch.hmc")]),
    ("import vihmc_torch.models.fno as fno\n", [(1, "vihmc_torch.models.fno")]),
    ("from ..pipelines import common\nfrom . import ravel\n",
     [(1, "vihmc_torch.pipelines.common")]),
    ("from vihmc_torch.core.profiling import count\nimport torch\n", []),
])
def test_the_layering_check_sees_every_kind_of_import(source, upward):
    assert _upward(source) == upward

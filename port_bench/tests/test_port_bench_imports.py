"""No module of the benchmark imports JAX or the JAX package (top-level names
compared whole: ``vihmc_torch`` begins with ``vihmc_t``), and the references
import nothing of the program."""

import ast
import glob
import os

import pytest

from port_bench.harness.cells import BENCH_DIR

FILES = sorted(glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "vihmc_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(f, BENCH_DIR) for f in FILES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH_DIR, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    assert "vihmc_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "torch", "numpy", "port_bench"}


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import vihmc_torch.core\nfrom jax import numpy\nimport jaxlib_like\n")
    assert top_level_imports(str(p)) == {"vihmc_torch", "jax", "jaxlib_like"}
    assert top_level_imports(str(p)) & FORBIDDEN == {"jax"}

"""What the benchmark may import and read: no module under perfbench/
imports jax, jaxlib, flax or the JAX package (top-level names compared
whole: the program's name begins with the JAX package's); the reference
imports nothing of the program; nothing reads benchmarks/."""
import ast
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not top_names(path) & FORBIDDEN


def test_reference_takes_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in top_names(path), path
        assert "repro_torch" not in path.read_text(), path


def test_nothing_reads_the_old_benchmarks():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        assert "benchmarks" not in top_names(path), path
        assert "benchmarks/" not in path.read_text(), path


def test_a_run_loads_none_of_them():
    """A whole CPU run of a cell leaves none of them in sys.modules."""
    import time

    import harness
    import run
    from conftest import SMALL
    cell = harness.benchmark()["workloads"][0]["name"]
    run.run_cell(cell, 3, 0.2, False, device="cpu",
                 t_start=time.perf_counter(), overrides=SMALL)
    assert not {m.split(".")[0] for m in sys.modules} & FORBIDDEN

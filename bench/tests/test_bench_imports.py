"""No run loads JAX or the JAX package (top-level names compared whole,
since ``repro_torch`` begins with ``repro``), the plain reference imports
nothing of the program, nothing under bench/ reads the JAX package's
benchmarks/, and a machine without a card gets no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(harness.BENCH)
ROOT = BENCH.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=240)


def test_names_are_compared_whole():
    loaded = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
              "repro", "repro.core", "jax", "jaxlib.xla_client", "flax.nn"]
    assert harness.forbidden_modules(loaded) == [
        "flax.nn", "jax", "jaxlib.xla_client", "repro", "repro.core"]


def test_a_run_of_each_cell_loads_neither_jax_nor_the_jax_package():
    out = _run("""
import time, sys
from bench import harness, measure
from bench.tests.cells import CELLS, small
for name in CELLS:
    measure.measure(small(name), 3, 0.2, True, "cpu", time.perf_counter())
assert "repro_torch" in sys.modules
print("LOADED", harness.forbidden_modules())
""")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_the_reference_imports_nothing_of_the_program():
    out = _run("""
import sys
from bench import harness
before = set(sys.modules)
ref = harness.load_reference("dense_lm")
new = set(sys.modules) - before
print(sorted(m for m in new if m.split(".")[0] in
             ("repro_torch", "repro", "jax", "jaxlib", "bench")))
""")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_bench_module_imports_jax_the_jax_package_or_its_benchmarks(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert "benchmarks/" not in path.read_text()
    if "reference" in path.parts:
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "torch"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "yi-6b.doc_qa",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

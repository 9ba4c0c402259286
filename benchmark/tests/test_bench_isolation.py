"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "pacingpseudo_tpu"}


def _top_levels_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_reference_imports_neither_jax_nor_the_port():
    names = _top_levels_after(
        "import sys; sys.path[:0] = ['benchmark']\n"
        "import reference.step, reference.model, reference.aug\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not names & (JAX | {"pacingpseudo_torch"})


def test_reference_sources_import_only_torch_numpy_and_themselves():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in {"torch", "numpy", "math", "typing", "dataclasses",
                                             "__future__", "reference"}, (path.name, mod)


def test_a_run_loads_no_jax():
    """A whole run of a cell, cut to the CPU's size, then the run's own
    check of ``sys.modules``."""
    names = _top_levels_after(
        "import sys, time; sys.path[:0] = ['benchmark', 'benchmark/tests', '.']\n"
        "import torch; torch.set_num_threads(2)\n"
        "import run\n"
        "from conftest import tiny_cell\n"
        "from harness import cell as C\n"
        "C.run_cell(tiny_cell('chaos-experiment.train'), 3, 0.0, False, 'cpu', time.perf_counter())\n"
        "assert run.forbidden_modules() == []\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "pacingpseudo_torch" in names and not names & JAX

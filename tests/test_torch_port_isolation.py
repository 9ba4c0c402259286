"""The port stands alone: no module of ``pacingpseudo_torch``, not
``chip_smoke.py``, and not the study's scripts (``STUDY_SCRIPTS``) import
JAX, flax, optax or the JAX package.

Two checks: a fresh interpreter imports every port module (and, apart,
the study's scripts) and finds none of them in ``sys.modules``, and an AST
scan of the sources finds no such import statement (also inside
functions, where the first check cannot see it).
"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "pacingpseudo_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pacingpseudo_tpu")
STUDY_SCRIPTS = (ROOT / "scripts" / "quality_study_torch.py",
                 ROOT / "scripts" / "quality_study_compare.py",
                 ROOT / "scripts" / "study_r3_pool_torch.py",
                 ROOT / "scripts" / "lvsc_rehearsal_torch.py",
                 ROOT / "scripts" / "lvsc_compare.py")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _is_forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = json.loads(out.splitlines()[-1])
    for module in ("pacingpseudo_torch.train.step", "pacingpseudo_torch.train.loop",
                   "pacingpseudo_torch.train.checkpoint", "pacingpseudo_torch.cli.train",
                   "pacingpseudo_torch.utils.meters", "pacingpseudo_torch.evals.infer",
                   "pacingpseudo_torch.evals.hd", "pacingpseudo_torch.cli.inference",
                   "pacingpseudo_torch.tools.prepare_data", "pacingpseudo_torch.tools.medio",
                   "pacingpseudo_torch.cli.prepare_data",
                   "pacingpseudo_torch.cli.scribble_tools",
                   "pacingpseudo_torch.data.resident", "pacingpseudo_torch.train.graph",
                   "pacingpseudo_torch.cli.sweep", "pacingpseudo_torch.parallel.mesh",
                   "pacingpseudo_torch.parallel.spatial",
                   "pacingpseudo_torch.data.native.loader",
                   "pacingpseudo_torch.tools.study_summary"):
        assert module in loaded
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_the_study_scripts_load_no_jax():
    """Each script as its ``main`` runs it: the runner's arms and summary
    import ``cli.train``, ``cli.inference`` and ``tools.study_summary``."""
    code = (
        "import importlib.util, json, sys\n"
        f"for path in {[str(p) for p in STUDY_SCRIPTS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('s', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import pacingpseudo_torch.cli.train, pacingpseudo_torch.cli.inference\n"
        "import pacingpseudo_torch.tools.study_summary\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = json.loads(out.splitlines()[-1])
    assert [m for m in loaded if _is_forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + list(STUDY_SCRIPTS),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == []

"""Nothing the harness imports is JAX or the JAX package, and the plain
references import nothing of the program; names are compared by their
whole top-level part, since the port's name begins with the JAX
package's."""
import ast
import subprocess
import sys

import pytest

from portbench.tests.common import ROOT

PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "datafusion_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            names.add("__import__")
    return names


SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_references_import_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "datafusion_tpu_torch" not in names
    assert "__import__" not in names
    assert names <= {"torch", "numpy", "datetime", "portbench", "__future__"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module == "portbench.reference.common"


BLOCKED_RUN = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "datafusion_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from portbench import harness
r = harness.run("tpch-sf10-scan", 5, 0.5, False, "cpu", scale=2e-4,
                log=lambda *a: None)
assert r["correct"], r
r = harness.run("tpch-sf10-chains", 5, 0.5, True, "cpu", scale=2e-4,
                log=lambda *a: None)
assert r["correct"], r
print("loaded", harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []"

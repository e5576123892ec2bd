"""No module of the benchmark imports the JAX stack or the JAX package; the references import nothing of
the program. Top-level module names are compared whole: ``semanticlens_tpu_torch`` (the program) begins
with ``semanticlens_tpu`` (the JAX package) and is not it."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "semanticlens_tpu"}
PROGRAM = "semanticlens_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))
REFERENCES = sorted((BENCH / "reference").glob("*.py")) + sorted((BENCH / "configs").glob("*.reference.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_references_import_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    for name in top_level_imports(path) - {"__future__", "math", "torch", "numpy", "contextlib", "portbench"}:
        raise AssertionError(f"{path.name} imports {name}")


def test_names_are_compared_whole():
    assert "semanticlens_tpu_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(BENCH / "kinds" / "sweep.py") >= {"portbench", "torch"}


def test_references_load_no_program_module_transitively():
    """Importing every reference (and what it imports) leaves no program or JAX module in ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import sys, importlib, importlib.util\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        f"for i, p in enumerate({[str(p) for p in REFERENCES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ref{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import portbench.harness.inputs\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {PROGRAM})

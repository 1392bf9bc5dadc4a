"""No module of the benchmark imports JAX or the JAX package, and the plain reference
imports nothing of the program either: top-level module names, compared whole."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from cgbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpusparse"}
MODULES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path) -> set:
    """The top-level names a file imports; a relative import counts as the package's."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("cgbench" if node.level else node.module.partition(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    if "reference" in path.relative_to(spec.HERE).parts:
        assert _imports(path) <= {"__future__", "torch"}


def test_a_dry_import_loads_neither():
    code = ("import importlib, pathlib, sys\n"
            "from cgbench import spec\n"
            "for p in sorted(spec.HERE.rglob('*.py')):\n"
            "    if p.parent.name == 'metrics':\n"
            "        spec.reader(p.stem)\n"
            "    elif p.parent.name == 'problems':\n"
            "        spec.problem(p.stem)\n"
            "    elif p.name != 'run.py':\n"
            "        rel = p.relative_to(spec.ROOT).with_suffix('')\n"
            "        importlib.import_module('.'.join(rel.parts).removesuffix('.__init__'))\n"
            "import tpusparse_torch.solvers.cg_sharded, tpusparse_torch.ops\n"
            "print(sorted({m.partition('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cgbench" in loaded and "tpusparse_torch" in loaded
    assert not loaded & FORBIDDEN

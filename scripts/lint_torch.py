#!/usr/bin/env python
"""The checks of ``scripts/lint.py`` over the PyTorch/CUDA port: ``tpusparse_torch/``
(Python, and its CUDA and C++ sources ``.cu``, ``.cuh``, ``.cpp``), ``chip_smoke.py`` and
``tests/test_torch_*.py``.

    python scripts/lint_torch.py

Python: syntax, tabs, trailing whitespace, lines over 99 characters, a missing newline at
the end, unused top-level imports; CUDA and C++: the same whitespace checks and lines over
100.  Exit 1 and one line per finding, as ``scripts/lint.py``, whose functions it runs.
"""

from __future__ import annotations

import ast
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from lint import MAX_LEN, MAX_LEN_CPP, ROOT, _check_text, _unused_imports

PORT = ROOT / "tpusparse_torch"
CPP_SUFFIXES = (".cu", ".cuh", ".cpp")


def _py_paths():
    yield from sorted(PORT.rglob("*.py"))
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "tests").glob("test_torch_*.py"))


def _cpp_paths():
    return sorted(p for p in PORT.rglob("*") if p.suffix in CPP_SUFFIXES)


def main() -> int:
    errors: list = []
    for path in _py_paths():
        text = path.read_text(encoding="utf-8")
        _check_text(path, text, MAX_LEN, errors)
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            errors.append(f"{path.relative_to(ROOT)}:{e.lineno}: syntax error: {e.msg}")
            continue
        _unused_imports(path, tree, text, errors)
    for path in _cpp_paths():
        _check_text(path, path.read_text(encoding="utf-8"), MAX_LEN_CPP, errors)
    if errors:
        print("\n".join(errors))
        print(f"\nlint_torch: {len(errors)} finding(s)")
        return 1
    print("lint_torch: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

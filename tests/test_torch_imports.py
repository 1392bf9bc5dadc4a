"""The port stands apart from JAX and never falls back to the CPU silently.

- Importing every module of tpusparse_torch, in a fresh interpreter, leaves ``jax`` and
  the JAX package (``tpusparse``, ``tpusparse.*``) out of ``sys.modules``.
- No source file of the port, nor chip_smoke.py, nor the card's test file, has an
  ``import tpusparse...`` or ``from tpusparse... import``: the port keeps its own copies
  of the host code it needs.
- A CUDA device requested where there is no CUDA raises.
- A kernel build without nvcc raises.
- chip_smoke.py exits non-zero, and prints no result, without a CUDA card.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from tpusparse_torch import _build, _device, generate

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import tpusparse_torch
mods = sorted(m.name for m in pkgutil.walk_packages(tpusparse_torch.__path__,
                                                    "tpusparse_torch."))
for m in mods:
    importlib.import_module(m)
print(json.dumps({"mods": mods, "jax": "jax" in sys.modules,
                  "tpusparse": sorted(m for m in sys.modules
                                      if m == "tpusparse" or m.startswith("tpusparse."))}))
"""


def test_no_module_imports_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["jax"], res
    assert res["tpusparse"] == [], res["tpusparse"]
    for mod in ("tpusparse_torch.ops", "tpusparse_torch.solvers.cg",
                "tpusparse_torch.kernels.stencil5", "tpusparse_torch.kernels.blas1",
                "tpusparse_torch.kernels.ell", "tpusparse_torch.kernels.dia",
                "tpusparse_torch.kernels._launch", "tpusparse_torch.kernels.stream_probe",
                "tpusparse_torch.cli.cg_solver",
                "tpusparse_torch.cli.spmv_bench", "tpusparse_torch.bench.sysinfo",
                "tpusparse_torch.bench.metrics", "tpusparse_torch.convert",
                "tpusparse_torch.generate", "tpusparse_torch.formats",
                "tpusparse_torch.io_mtx", "tpusparse_torch.native",
                "tpusparse_torch.bench.stats", "tpusparse_torch.bench.export",
                "tpusparse_torch.bench.probes", "tpusparse_torch.bench.profiling",
                "tpusparse_torch.cli.generate_matrix", "tpusparse_torch.dist",
                "tpusparse_torch.solvers.cg_sharded", "tpusparse_torch.cli.cg_solver_multichip",
                "tpusparse_torch.bench.sharded_overlap"):
        assert mod in res["mods"]


def _imports_of_the_jax_package(path):
    """(line, module) of every import of ``tpusparse`` or ``tpusparse.*`` in a file,
    wherever it stands (top level or inside a function)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "tpusparse" or n.startswith("tpusparse.")]
    return found


def test_no_file_of_the_port_imports_the_jax_package():
    files = sorted((ROOT / "tpusparse_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): imp for f in files if (imp := _imports_of_the_jax_package(f))}
    assert bad == {}
    # the scan sees what it looks for: the CPU parity tests do import the JAX package
    found = dict(_imports_of_the_jax_package(ROOT / "tests" / "test_torch_cg.py")).values()
    assert {"tpusparse", "tpusparse.kernels", "tpusparse.solvers"} <= set(found)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.ones_field(4)  # the default device is CUDA
    assert _device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        _device.resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported dtype"):
        _device.resolve_dtype("bf16")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert _build._lib is None


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

"""The port's profiling module (tpusparse_torch.bench.profiling) on the CPU.

- The phase names are the JAX package's.
- ``profiled_run`` writes a Chrome trace JSON into its log directory and returns the
  function's result.
- Every loop of ``cg_solve`` and the stepped loop mark their phases: a solve under
  ``capture_trace`` shows ``SpMV``, ``BLAS_AXPY`` and (classic loops) ``BLAS_Update_P``;
  the stepped loop also ``Dot_Product`` around its reads of the dots (``annotate``).
"""

import json

import pytest
import torch

from tests.test_torch_host import carry
from tpusparse import formats
from tpusparse.bench import profiling as jax_profiling
from tpusparse_torch import ops
from tpusparse_torch.bench import profiling
from tpusparse_torch.solvers import cg


def _names(logdir):
    (trace,) = logdir.glob("*.json")
    return {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


def test_phase_names_are_jax_names():
    for name in ("SOLVER", "ITERATION", "SPMV", "DOT", "AXPY", "HALO"):
        assert getattr(profiling, f"PHASE_{name}") == getattr(jax_profiling, f"PHASE_{name}")


def test_profiled_run_writes_a_trace(tmp_path):
    def work(n, scale=1.0):
        with profiling.scope(profiling.PHASE_DOT), profiling.annotate("host_step"):
            return float(torch.arange(n, dtype=torch.float64).sum()) * scale

    assert profiling.profiled_run(work, 10, scale=2.0, logdir=str(tmp_path / "t")) == 90.0
    assert any((tmp_path / "t").iterdir())
    assert {"Dot_Product", "host_step"} <= _names(tmp_path / "t")
    with profiling.annotate("no_profiler") as r:  # no profiler runs: no range, no op call
        assert r is None


@pytest.mark.parametrize("mode,kwargs,update_p", [
    ("stencil5", {}, True),
    ("stencil5-const", {}, False),
    ("stencil5-const", {"recompute_ap": False}, True),
    ("stencil5", {"fused_pupdate": True}, False),
])
def test_cg_solve_phases_in_the_trace(tmp_path, mode, kwargs, update_p):
    st = formats.Stencil5(grid_size=12, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator(mode, carry(st), dtype=torch.float64, device="cpu")
    with profiling.capture_trace(str(tmp_path)) as logdir:
        _, s = cg.cg_solve(op, b_is_ones=True, **kwargs)
    assert logdir == str(tmp_path) and s.converged
    names = _names(tmp_path)
    assert {"SpMV", "BLAS_AXPY"} <= names
    assert ("BLAS_Update_P" in names) == update_p


def test_stepped_phases_in_the_trace(tmp_path):
    st = formats.Stencil5(grid_size=12, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("csr", carry(st), dtype=torch.float64, device="cpu")
    x, s = profiling.profiled_run(cg.cg_solve_stepped, op.run_device_dot, op.ones_b(),
                                  logdir=str(tmp_path))
    assert s.converged and s.spmv_time_ms > 0
    # the reads of <p, Ap> and <r, r> to the host are Dot_Product ranges (annotate)
    assert {"SpMV", "BLAS_AXPY", "BLAS_Update_P", "Dot_Product"} <= _names(tmp_path)

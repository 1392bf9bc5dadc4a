"""The port's profiling module (tpusparse_torch.bench.profiling) on the CPU.

- The phase names are the JAX package's.
- ``profiled_run`` writes a Chrome trace JSON into its log directory and returns the
  function's result.
- Every loop of ``cg_solve`` and the stepped loop mark their phases: a solve under
  ``capture_trace`` shows ``SpMV``, ``BLAS_AXPY`` and (classic loops) ``BLAS_Update_P``;
  the stepped loop also ``Dot_Product`` around its reads of the dots (``annotate``).
- The recorder: off, a solve records nothing; on, a solve of the graph loop's structure
  (``DeviceLoop._run_host``) records one ``CG_Solver`` with ``CG_Slot``, ``CG_Start``,
  ``CG_Replay`` and ``CG_Read`` under it, all of its id, and no ``CG_Capture`` (only a
  card captures: ``tests/test_torch_cuda.py``); two gloo ranks give one solve one id; a
  span starts where the profiler's range around the same work starts (one clock);
  set-up's ``Operator_Build``.
"""

import json
import time

import numpy as np
import pytest
import torch

from tests.test_torch_host import carry
from tpusparse import formats
from tpusparse.bench import profiling as jax_profiling
from tpusparse_torch import dist, ops
from tpusparse_torch.bench import profiling
from tpusparse_torch.solvers import cg, cg_sharded


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


@pytest.fixture
def recorder():
    """The recorder emptied, off, and left so."""
    profiling.reset()
    was = profiling.record(False)
    yield
    profiling.record(was)
    profiling.reset()


def _const_op(g=12):
    st = formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    return ops.get_operator("stencil5-const", carry(st), dtype=torch.float64, device="cpu")


def test_recording_off_records_nothing(recorder):
    op = _const_op()
    cg.reset_counts()
    _, s = cg.cg_solve(op, b_is_ones=True)
    assert s.converged and profiling.spans() == []
    assert cg.COUNTS["solves"] == 1 and cg.COUNTS["captures"] == 0


def test_eager_solve_spans(recorder):
    op = _const_op()
    with profiling.recording():
        _, s = cg.cg_solve(op, b_is_ones=True)
    spans = profiling.spans()
    root = spans[0]
    assert root.name == "CG_Solver" and root.parent is None and root.solve is not None
    assert spans[1].name == "CG_Start" and spans[1].parent == 0
    assert all(sp.solve == root.solve and sp.end_ns >= sp.start_ns for sp in spans)
    assert sum(sp.name == "SpMV" for sp in spans) == s.iterations  # the phase scopes too
    assert profiling.totals()["CG_Solver"][0] == 1


@pytest.mark.parametrize("loop", ["classic", "recompute"])
def test_graph_structured_solve_spans(recorder, loop):
    """Two solves of the graph loop's structure on the CPU, each under its root span as
    the solvers open it (``cg.solve_scope``)."""
    op = _const_op()
    dl = cg.DeviceLoop(op, loop, 1000, 1e-6)
    cg.reset_counts()
    with profiling.recording():
        for _ in range(2):
            with cg.solve_scope():
                x, k, _rr, _bb = dl.solve(None, None, True)
            del x
    assert cg.COUNTS == {"host_reads": 2, "replays": 0, "solves": 2, "captures": 0}
    spans = profiling.spans()
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    assert [spans[i].name for i in roots] == ["CG_Solver"] * 2
    assert [spans[i].solve for i in roots] == [1, 2]
    for i in roots:
        kids = [sp for sp in spans if sp.parent == i]
        assert [sp.name for sp in kids] == ["CG_Slot", "CG_Start", "CG_Replay", "CG_Read"]
        assert all(sp.solve == spans[i].solve for sp in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert not any(sp.name == "CG_Capture" for sp in spans)  # a card's only
    # the iterations' phases run under the replay (the loop's structure on the host)
    replays = {i for i, sp in enumerate(spans) if sp.name == "CG_Replay"}
    phases = [sp for sp in spans if sp.name == "SpMV"]
    assert len(phases) == 2 * k and all(sp.parent in replays for sp in phases)


def test_reset_while_a_span_is_open(recorder):
    with profiling.recording():
        with profiling.scope("outer"):
            profiling.reset()
            with profiling.scope("inner", step=3) as sc:
                sc.attrs["more"] = True
        with profiling.scope("after"):
            pass
    assert [(sp.name, sp.parent, sp.attrs) for sp in profiling.spans()] == \
        [("inner", None, {"step": 3, "more": True}), ("after", None, {})]


def test_operator_build_span(recorder):
    with profiling.recording():
        _const_op()
        cg_sharded.make_sharded_operator(12, mode="stencil5", dtype=torch.float64,
                                         device="cpu", shard=(0, 2))
    assert [sp.name for sp in profiling.spans()] == ["Operator_Build"] * 2
    cg_sharded.clear_caches()


def test_span_and_profiler_range_share_a_clock(recorder):
    """A span opened inside a ``record_function`` around the same work: its start lies
    within 2 ms of the range's on the profiler's events (``time.time_ns()``, the
    profiler's clock)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording():
        with record_function("around"), profiling.scope("CG_Start"):
            torch.ones(64).add_(1)
    (span,) = profiling.spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("around", "CG_Start"):  # the scope's own range too
        assert abs(events[name].start_ns() - span.start_ns) < 2_000_000, name
    assert abs(span.start_ns - time.time_ns()) < 60e9


def _gloo_rank(device):
    """Two solves on this gloo rank with recording on: every rank's [(solve id, start of
    its CG_Solver)] and the names of the first solve's spans."""
    op = cg_sharded.make_sharded_operator(16, mode="stencil5", dtype=torch.float64,
                                          device=device)
    b = np.random.RandomState(3).rand(16, 16)
    with profiling.recording():
        for _ in range(2):
            cg_sharded.cg_solve_sharded(16, b=b, operator=op)
    spans = profiling.spans()
    roots = [(sp.solve, sp.start_ns) for sp in spans if sp.name == "CG_Solver"]
    first = [sp.name for sp in spans if sp.solve == roots[0][0] and sp.parent == 0]
    every = dist._all_objects((roots, first))
    cg_sharded.clear_caches()
    return every if dist.rank() == 0 else None


def test_gloo_ranks_give_a_solve_one_id():
    every = dist.launch_local(_gloo_rank, 2, device="cpu")
    ids = [[solve for solve, _t in roots] for roots, _first in every]
    assert ids == [[1, 2], [1, 2]]
    assert all(first[0] == "CG_Start" for _roots, first in every)
    # one host: the ranks' starts of one solve lie on one clock, a few ms apart at most
    for (a, ta), (b, tb) in zip(*(roots for roots, _first in every)):
        assert a == b and abs(ta - tb) < 5e9

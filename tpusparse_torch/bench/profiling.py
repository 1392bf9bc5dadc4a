"""Tracing and profiling of the port: its counterpart of ``tpusparse/bench/profiling.py``.

The reference's observability (SURVEY.md §5.1), in PyTorch:
  - NVTX phase ranges (CG_Solver, CG_Iteration, SpMV, Dot_Product, BLAS_AXPY,
    Halo_Exchange_MPI; cg_solver_mgpu_partitioned.cu:540-543)  ->  ``scope``: a
    ``torch.cuda.nvtx`` range with the same phase name where CUDA is available, and a
    ``torch.profiler.record_function`` of that name while a profiler runs (outside one
    it would still cost an operator call per phase, for nothing);
  - cudaProfilerStart/Stop around one solve excluded from the statistics
    (cg_solver_mgpu_stencil.cu:115-117)  ->  ``profiled_run``;
  - the nsys capture  ->  ``capture_trace``: ``torch.profiler`` over the CPU (and the card's
    kernels where there is one), written as a Chrome trace JSON
    (``<host>_<pid>.<ms>.pt.trace.json``) into the log directory.  Open it in
    chrome://tracing or https://ui.perfetto.dev, or point TensorBoard's PyTorch profiler
    plugin at the directory.

It is also the port's one record of spans and counters.  While recording is on
(``record(True)``, or inside ``recording()``; off by default), every ``scope`` appends a
``Span`` to an in-memory list (``spans()``, emptied by ``reset()``): its name, its start and
end in ``time.time_ns()`` (the clock ``torch.profiler`` stamps its events with, Unix-epoch
nanoseconds, which every process of a host shares, so spans compare directly with a
trace's device intervals and with other ranks' spans), the index of its parent span, the
id of the solve it belongs to and its attributes.  Off, a scope costs one flag test more
and records nothing.  The spans the port opens:

  - a solve's (``solvers/cg.py``, ``solvers/cg_sharded.py``): ``CG_Solver``, the root,
    which takes the solve's id from ``cg.COUNTS["solves"]`` (ranks solve in lockstep, so
    one id on every rank is one solve); ``CG_Slot``, picking a free solution slot, with
    ``CG_Capture`` inside it whenever a slot's graph is captured; ``CG_Start``, the start
    run eagerly (r0, x0, the first dots); ``CG_Replay``, the graph's launch (on a rank, the
    host's wait for the replay too); ``CG_Read``, the status read that ends in the host's
    sync.  The eager loops open ``CG_Solver`` and ``CG_Start``, and their iterations the
    phase names above;
  - set-up's: ``Kernel_Load`` (``_build.lib()``'s build or load, attribute ``built``),
    ``Operator_Build`` (``ops.get_operator``, ``cg_sharded.make_sharded_operator``),
    ``Stencil27_Build`` inside it (``generate.make_stencil27_ell_device``, attributes
    ``nx``, ``ny``, ``nz``, ``width``, ``slots`` and the operand's ``bytes``) and
    ``NCCL_Group`` (``dist.nccl_group``'s group and its first all-gather).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

# The phase names, as the reference's NVTX strings, so that traces line up side by side
PHASE_SOLVER = "CG_Solver"
PHASE_ITERATION = "CG_Iteration"
PHASE_SPMV = "SpMV"
PHASE_DOT = "Dot_Product"
PHASE_AXPY = "BLAS_AXPY"
PHASE_HALO = "Halo_Exchange"
# the classic loop's p update, the name the JAX loop gives it
PHASE_UPDATE_P = "BLAS_Update_P"
# the graph loop's boundaries within a solve (``CG_Solver``)
PHASE_SLOT = "CG_Slot"
PHASE_CAPTURE = "CG_Capture"
PHASE_START = "CG_Start"
PHASE_REPLAY = "CG_Replay"
PHASE_READ = "CG_Read"
# set-up
PHASE_KERNEL_LOAD = "Kernel_Load"
PHASE_OPERATOR_BUILD = "Operator_Build"
PHASE_STENCIL27_BUILD = "Stencil27_Build"
PHASE_NCCL_GROUP = "NCCL_Group"
# every name the port's scopes open
NAMES = (PHASE_SOLVER, PHASE_ITERATION, PHASE_SPMV, PHASE_DOT, PHASE_AXPY, PHASE_HALO,
         PHASE_UPDATE_P, PHASE_SLOT, PHASE_CAPTURE, PHASE_START, PHASE_REPLAY, PHASE_READ,
         PHASE_KERNEL_LOAD, PHASE_OPERATOR_BUILD, PHASE_STENCIL27_BUILD, PHASE_NCCL_GROUP)


@dataclasses.dataclass
class Span:
    """One recorded scope: ``start_ns`` and ``end_ns`` in ``time.time_ns()`` (``end_ns``
    None while it is open), ``parent`` the index in ``spans()`` of the scope it opened in
    (None at the top), ``solve`` the id of the solve it belongs to (None outside one)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    solve: Optional[int]
    attrs: dict


_recording = False
_SPANS: list = []
_open = threading.local()  # .stack: the indices of this thread's open spans, innermost last


def record(on: bool = True) -> bool:
    """Turn recording on or off; returns whether it was on."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Recording on inside the context, as it was after."""
    was = record(True)
    try:
        yield
    finally:
        record(was)


def spans() -> list:
    """The spans recorded since the last ``reset``, in the order they opened."""
    return list(_SPANS)


def reset() -> None:
    """Forget every recorded span; a span open now gets no parent's index."""
    _SPANS.clear()
    _open.stack = []


def totals() -> dict:
    """{name: (count, seconds)} of the closed spans, in the order each name first
    opened."""
    out = {}
    for sp in _SPANS:
        if sp.end_ns is not None:
            n, s = out.get(sp.name, (0, 0.0))
            out[sp.name] = (n + 1, s + (sp.end_ns - sp.start_ns) / 1e9)
    return out


def summary() -> str:
    """``totals`` as one line: ``spans (count, s): name count seconds, ...``."""
    return "spans (count, s): " + ", ".join(
        f"{name} {n} {s:.6f}" for name, (n, s) in totals().items())


def _begin(name, solve, attrs) -> Span:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent = stack[-1] if stack else None
    if parent is not None and solve is None:
        solve = _SPANS[parent].solve
    span = Span(name, time.time_ns(), None, parent, solve, attrs)
    stack.append(len(_SPANS))
    _SPANS.append(span)
    return span


def _end(span: Span) -> None:
    span.end_ns = time.time_ns()
    stack = _open.stack  # scopes nest: the span is the innermost, unless a reset came
    if stack and _SPANS[stack[-1]] is span:
        stack.pop()


class scope:
    """A named phase, as a context manager: an NVTX range where CUDA is available (a
    CPU-only build has no NVTX), a ``record_function`` range, which ``torch.profiler``
    records, while a profiler runs, and a ``Span`` while recording is on.  ``solve``: the
    id of the solve the span opens (``CG_Solver``), else its parent's; ``attrs`` go into
    the span, and may be set while it is open (``scope.attrs``)."""

    __slots__ = ("name", "solve", "attrs", "_range", "_nvtx", "_span")

    def __init__(self, name: str, solve: Optional[int] = None, **attrs):
        self.name, self.solve, self.attrs = name, solve, attrs

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._nvtx = _cuda()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._span = _begin(self.name, self.solve, self.attrs) if _recording else None
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _end(self._span)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)


@functools.lru_cache(maxsize=1)
def _cuda() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def capture_trace(logdir: str = "results/traces") -> Iterator[str]:
    """Profile everything inside the context: the CPU and, where CUDA is available, the
    card's kernels; the Chrome trace JSON goes into ``logdir`` when the context closes.
    Yields the log directory."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def profiled_run(fn, *args, logdir: str = "results/traces", **kwargs):
    """Run ``fn`` once under ``capture_trace``, the card synchronized before the capture
    closes: the reference's dedicated cudaProfilerStart/Stop run
    (cg_solver_mgpu_stencil.cu:111-121), excluded from any statistics."""
    with capture_trace(logdir):
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out


def annotate(name: str):
    """A host-side range for the phase-split (stepped) loop, which marks its reads of the
    dots to the host with it: a ``record_function`` while a profiler runs, and nothing
    otherwise (no NVTX: no device work runs inside it)."""
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_RANGE


_NO_RANGE = contextlib.nullcontext()

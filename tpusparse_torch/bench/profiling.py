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
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator

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


class scope:
    """A named phase, as a context manager: an NVTX range where CUDA is available (a
    CPU-only build has no NVTX), and a ``record_function`` range, which
    ``torch.profiler`` records, while a profiler runs."""

    __slots__ = ("name", "_range", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._nvtx = _cuda()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc):
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

"""A cell on one card: the program's single-device CG on the configuration's problem.

The window drives ``tpusparse_torch.solvers.cg.cg_solve(op, b, graph=None)`` with ``op``
from ``tpusparse_torch.ops.get_operator(mode, operand, dtype, device)``, ``operand`` the
problem's (``problems/<name>.py``; for ``lap5`` the planes-free stencil, whose operands
the program makes on the device).
"""

from __future__ import annotations

import functools
import gc
import math
import time

import torch

from . import check, inputs, smi, trace, window
from .reference import cg as reference


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phases(t_start, stamps, opened) -> dict:
    """Seconds from one set-up stamp (``time.time()``) to the next, the first from the
    process's start, the last to the window's opening."""
    out, last = {}, t_start
    for name, t in [*stamps.items(), ("window opens", opened)]:
        out[name] = t - last
        last = t
    return out


class Program:
    """The system under test for one cell: its operator, built from the configuration's
    problem in ``dtype`` (the configuration's own unless a control asks for a lower one)."""

    def __init__(self, cell, device, dtype: str | None = None, grid: int | None = None):
        from tpusparse_torch import ops
        from tpusparse_torch.solvers import cg

        c = cell.config
        self.dtype = inputs.DTYPES[dtype or c["dtype"]]
        # the program's bf16 state runs the classic loop only
        self.recompute = (cell.traffic["loop"] == "recompute"
                          and self.dtype != torch.bfloat16)
        self.config = cg.CGConfig(max_iters=c["max_iters"], tolerance=c["tolerance"])
        self._cg = cg
        problem = cell.problem()
        t0 = time.perf_counter()
        self.op = ops.get_operator(cell.traffic["mode"], problem.operand(c, grid),
                                   self.dtype, device)
        _sync(device)
        self.build_s = time.perf_counter() - t0

    def solve(self, b):
        """One solve of b, a field of the problem's shape on the operator's device: (x,
        CGStats)."""
        return self._cg.cg_solve(self.op, b.reshape(self.op.field_shape),
                                 config=self.config, recompute_ap=self.recompute,
                                 graph=None)

    def free(self) -> None:
        self.op.free()
        self.op = None


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        grid: int | None = None, wrap=None) -> dict:
    """One run of a one-card cell: set-up, the window, with ``traced`` a traced segment,
    then the check.  ``wrap`` (tests) takes the timed solve and returns the one to run.
    Returns the run's record, the fields ``harness.result`` reads."""
    dev = torch.device(device)
    c, t = cell.config, cell.traffic
    problem = cell.problem()
    shape = problem.shape(c, grid)
    stamps = {"imports": time.time()}
    if traced:
        trace.prime(dev)
    b = inputs.right_hand_side(shape, seed, inputs.DTYPES[c["dtype"]], dev, t["b"])
    _sync(dev)
    stamps["b"] = time.time()
    prog = Program(cell, dev, grid=grid)
    build_s = prog.build_s
    stamps["operator"] = time.time()

    def solve():
        return prog.solve(b)

    if wrap is not None:
        solve = wrap(solve)
    first_s = window.first_solves(solve)
    stamps["first solves"] = time.time()
    warm = window.warm_up(solve, t["warmup"])
    stamps[f"warm-up ({len(warm)} solves)"] = time.time()
    sampler = smi.Sampler()
    opened = time.time()
    w = window.run(solve, seed, seconds=seconds)
    closed = time.time()
    samples = sampler.stop()
    traces = [trace.traced(solve, t["trace_solves"], dev)] if traced else []
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    kept = w.kept
    w.kept = None
    prog.free()
    del prog, solve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    x_ref, ref_iters = reference.solve(b, functools.partial(problem.apply, config=c),
                                       c["tolerance"], c["max_iters"])
    return {
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "setup_s": opened - t_start,
        "setup_phases": _phases(t_start, stamps, opened),
        "operator_build_s": build_s,
        "first_solve_s": first_s,
        "times_ms": w.times_ms,
        "total_s": w.total_s,
        "iterations": w.iterations,
        "failed": w.failed,
        "kept_index": w.kept_index,
        "kept_iterations": w.kept_iterations,
        "ref_iterations": ref_iters,
        "iters_gap": check.iters_gap(w.iterations, ref_iters),
        "gap": check.field_gap(kept, x_ref),
        "scale": check.scale(x_ref),
        "traces": traces,
        "memory_peak_bytes": peak,
        "points": [math.prod(shape)],
        "smi": smi.within(samples, opened, closed),
    }

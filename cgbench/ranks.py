"""A cell on several ranks, one process a rank and rank r on card r: the program's
sharded CG over NCCL, each rank's loop replayed from its own CUDA graph.

The window drives ``tpusparse_torch.solvers.cg_sharded.cg_solve_sharded(g, b=b,
operator=op, graph=None)`` on every rank, ``op`` from the problem's ``sharded_operator``
(for ``lap5`` ``make_sharded_operator``: the rank's row band, its halos and dots passed
over the group ``dist.device_group`` picks, NCCL where every rank has a card of its own);
a problem without one runs on one card only.

This process (the one that prints the result) starts the ranks (``launch``) and touches
no card itself.  Every rank makes the whole b from the seed on its card and runs the same
solves in lockstep: rank 0 decides when warm-up has settled and how many solves the
window holds (its wall time over the warm-up's last solves), and the window is opened
and closed by a barrier of all ranks.  After the window every rank frees the program,
runs the reference on its card over the whole grid and compares its own band of x with
those rows, so the comparison covers every row of x without moving it off the cards.
"""

from __future__ import annotations

import functools
import gc
import math
import statistics
import time

import torch
import torch.distributed as tdist

from . import check, inputs, launch, single, smi, spec, trace, window
from .reference import cg as reference

# how long the ranks may take, from the start of the run to their last report, before
# they are stopped and the run fails
RANKS_BOUND_S = 330.0


class RankProgram:
    """The system under test on one rank: its band of the sharded operator.  ValueError,
    before anything is built, for a problem without ``sharded_operator``."""

    def __init__(self, cell, device, dtype: str | None = None, grid: int | None = None):
        spec.require_sharded(cell.problem_file)
        from tpusparse_torch.solvers import cg_sharded

        c = cell.config
        problem = cell.problem()
        self.g = problem.shape(c, grid)[0]  # the rows the bands split
        self.dtype = inputs.DTYPES[dtype or c["dtype"]]
        self.recompute = (cell.traffic["loop"] == "recompute"
                          and self.dtype != torch.bfloat16)
        self.tolerance, self.max_iters = c["tolerance"], c["max_iters"]
        self._cg = cg_sharded
        t0 = time.perf_counter()
        self.op = problem.sharded_operator(c, grid, cell.traffic["mode"], self.dtype, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_s = time.perf_counter() - t0
        lo = self.op.row_lo
        self.rows = (lo, min(lo + self.op.band, self.g))  # the band's grid rows, no pad

    def solve(self, b):
        """One solve of the whole b: (this rank's band of x, CGStats)."""
        return self._cg.cg_solve_sharded(self.g, b=b, operator=self.op,
                                         tolerance=self.tolerance, max_iters=self.max_iters,
                                         recompute_ap=self.recompute, graph=None)

    def free(self) -> None:
        self.op = None
        self._cg.clear_caches()


def _agree(value):
    """Rank 0's ``value`` on every rank."""
    box = [value]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def rank_run(r, dev, cell, seed, seconds, traced, t_start, grid, wrap):
    """A rank's share of one run (``harness.start_ranks``): its record."""
    from . import harness

    c, t = cell.config, cell.traffic
    problem = cell.problem()
    shape = problem.shape(c, grid)
    stamps = {"imports and the group": time.time()}
    if traced:
        trace.prime(dev)
    b = inputs.right_hand_side(shape, seed, inputs.DTYPES[c["dtype"]], dev, t["b"])
    stamps["b"] = time.time()
    prog = RankProgram(cell, dev, grid=grid)
    build_s, rows = prog.build_s, prog.rows
    stamps["operator"] = time.time()

    def solve():
        return prog.solve(b)

    if wrap is not None:
        solve = wrap(solve)
    first_s = window.first_solves(solve)
    stamps["first solves"] = time.time()
    warm = window.warm_up(solve, t["warmup"], decide=_agree)
    count = _agree(max(1, math.ceil(seconds * 1e3 / statistics.median(warm[-3:]))))
    stamps[f"warm-up ({len(warm)} solves)"] = time.time()
    tdist.barrier()
    opened = time.time()
    w = window.run(solve, seed, count=count)
    tdist.barrier()
    closed = time.time()
    traces = []
    if traced:
        tdist.barrier()
        traces.append(trace.traced(solve, t["trace_solves"], dev))
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
        "setup_phases": single._phases(t_start, stamps, opened),
        "window_wall": (opened, closed),
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
        "gap": check.field_gap(kept[:rows[1] - rows[0]], x_ref, rows),
        "scale": check.scale(x_ref),
        "traces": traces,
        "memory_peak_bytes": peak,
        "points": (rows[1] - rows[0]) * math.prod(shape[1:]),
        "leaked": harness.leaked(),
    }


def finish(ranks: launch.Ranks, t_start: float) -> dict:
    """The run's record from its started ranks: rank 0's window and set-up, the worst of
    the ranks elsewhere.  Every rank has ended when this returns or raises."""
    sampler = smi.Sampler()
    ok = False
    try:
        got = ranks.collect(t_start + RANKS_BOUND_S)
        ok = True
    finally:
        samples = sampler.stop()
        ranks.stop(kill=not ok)
    zero = got[0]
    if any(x["kept_index"] != zero["kept_index"] for x in got):
        raise RuntimeError("the ranks kept different solves: "
                           f"{[x['kept_index'] for x in got]}")
    return {
        **{k: zero[k] for k in ("kind", "setup_s", "setup_phases", "times_ms", "total_s",
                                "iterations", "kept_index", "kept_iterations",
                                "ref_iterations", "scale")},
        "operator_build_s": max(x["operator_build_s"] for x in got),
        "first_solve_s": max(x["first_solve_s"] for x in got),
        "failed": max(x["failed"] for x in got),
        "gap": max(x["gap"] for x in got),
        "iters_gap": max(x["iters_gap"] for x in got),
        "traces": [tr for x in got for tr in x["traces"]],
        "memory_peak_bytes": max(x["memory_peak_bytes"] for x in got),
        "points": [x["points"] for x in got],
        "smi": smi.within(samples, *zero["window_wall"]),
        "leaked": sorted({m for x in got for m in x["leaked"]}),
    }

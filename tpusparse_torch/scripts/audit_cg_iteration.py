"""Per-iteration traffic audit of the CG loop: the port's counterpart of
``scripts/audit_cg_iteration.py``.

Times one CG iteration's phases at a grid, each the port's own kernel as its loops launch
it, and checks that they add up to the measured iteration of the graph loop (the analog
of the reference's per-phase iteration breakdown, docs/PROFILING_ANALYSIS.md:21-38).

Phases of the classic loop (11 words a point an iteration):
    spmv_dot   K3 with its dot (``run_device_dot``)       1R + 1W = 2 words a point
    update     K4 (``blas1.cg_update``: x, r, <r, r>)       4R + 2W = 6
    p_update   K5 (``blas1.p_update``: p = r + β·p)         2R + 1W = 3
and of the recompute loop (8 words a point an iteration):
    recompute_pass_a  K1 (``run_pupdate_dot_op``)         2R + 1W = 3
    recompute_pass_b  K2 (``run_update_recompute_op``)    3R + 2W = 5

A phase's time: chains of k_lo and of k_hi launches on fields made on the device (sin/cos
of the grid's indices), each chain captured as a CUDA graph and timed by CUDA events
around its replay, best of ``--reps``, and the slope between them
(``bench.probes.slope_seconds``); on the CPU the host clock stands in.  Launches on one
stream run in order, so no fence between them is needed (the JAX audit's
``optimization_barrier``).  Each phase's kernel launches are counted: its eager launch
(the wrapper's ``LAUNCHES``) and k a replay (``_launch.REPLAYED``); the twins on the CPU
count none.

The solves: graph-loop solves (``cg_solve``'s default on a card), b = ones, x0 = 0, the
median of ``--runs`` after two warm-ups, at max_iters = 0 (the fixed overhead: the start,
one replay, one read) and at max_iters = 100 in the classic and the recompute loop, each
of which must converge.  The audit closes when

    phase_sum ≈ (solve_ms − fixed_ms) / iterations     (closure_pct = 100 · ratio)

Writes ``results/cg_iter_audit_<g>_<tag>.json`` (``--out`` to choose; the tag is ``h100``
on an NVIDIA H100, else the device's name), with each phase's share of its bound: its
bytes over the card's data-sheet rate (``sysinfo.GPU_SPECS``: 3,350 GB/s on the H100).

    python -m tpusparse_torch.scripts.audit_cg_iteration [--grid 20480] [--reps 3]
        [--runs 5] [--out FILE] [--platform=cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

import torch

from .. import ops
from .._device import resolve_device
from ..bench import sysinfo
from ..bench.probes import slope_seconds
from ..formats import Stencil5
from ..kernels import _launch, blas1
from ..kernels import stencil5 as st5
from ..solvers import cg

# phase -> (words a point, the wrapper whose launches it counts, its module's LAUNCHES)
PHASES = {
    "spmv_dot": (2, "spmv_stencil5_const", st5.LAUNCHES),
    "update": (6, "cg_update", blas1.LAUNCHES),
    "p_update": (3, "p_update", blas1.LAUNCHES),
    "recompute_pass_a": (3, "spmv_stencil5_const_pupdate_dot", st5.LAUNCHES),
    "recompute_pass_b": (5, "cg_const_update_recompute", st5.LAUNCHES),
}
CLASSIC = ("spmv_dot", "update", "p_update")
RECOMPUTE = ("recompute_pass_a", "recompute_pass_b")


def device_tag(info) -> str:
    """``h100`` for an NVIDIA H100, else the device's name in lower case."""
    kind = info["device_kind"]
    return "h100" if "H100" in kind else re.sub(r"[^a-z0-9]+", "_", kind.lower()).strip("_")


def field(g, seed, dtype, device):
    """A deterministic, non-trivial (g, g) field made on the device: sin of the row index
    plus cos of the column index, scaled by the seed (no host upload)."""
    i = torch.arange(g, dtype=dtype, device=device)
    return (torch.sin(i * (1e-6 * (seed + 1)))[:, None]
            + torch.cos(i * (3e-7 * (seed + 2)))[None, :])


def chain_ms(launch, device, wrapper, k_lo=4, k_hi=16, reps=3) -> float:
    """Milliseconds of one ``launch()`` from the slope between chains of k_lo and k_hi
    launches, best of ``reps``.  On a card each chain is one CUDA graph, captured after
    one eager launch that records the wrappers' buffers (``_launch.Workspace``, as the
    graph loop records its body's) and timed by CUDA events around its replay: the
    chain's device time, as in the graph loop, with no host launch cost between the
    kernels.  The wrapper's own count holds the eager launch; the capture launches
    nothing (``_launch.set_apart``) and each replay counts its k launches as replayed
    (``_launch.count_replay``).  On the CPU the chain is a loop on the host clock."""
    if device.type != "cuda":
        def run(k):
            t0 = time.perf_counter()
            for _ in range(k):
                launch()
            return time.perf_counter() - t0

        run(k_lo)
    else:
        ws = _launch.Workspace(device)
        with _launch.use(ws):
            launch()
        torch.cuda.synchronize(device)

        def capture(k):
            graph = torch.cuda.CUDAGraph()
            with _launch.set_apart() as launches, torch.cuda.graph(graph), _launch.use(ws):
                for _ in range(k):
                    ws.rewind()
                    launch()
            if launches.get(wrapper) != k:
                raise RuntimeError(f"a chain of {k} captured {launches.get(wrapper)} "
                                   f"launches of {wrapper}")
            return graph, launches

        graphs = {k_lo: capture(k_lo), k_hi: capture(k_hi)}

        def run(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            graph, launches = graphs[k]
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            _launch.count_replay(launches)
            return start.elapsed_time(end) / 1e3

        run(k_lo)
    t_lo = min(run(k_lo) for _ in range(reps))
    t_hi = min(run(k_hi) for _ in range(reps))
    return slope_seconds(t_lo, t_hi, k_lo, k_hi) * 1e3


def timed_solve(op, cfg, recompute_ap, warmup=2, runs=5):
    """(median ms, iterations, converged) of graph-loop solves, b = ones; every x is
    dropped before the next solve, so each replays the loop's one slot."""
    times, stats = [], None
    for i in range(warmup + runs):
        x, stats = cg.cg_solve(op, config=cfg, b_is_ones=True, recompute_ap=recompute_ap)
        del x
        if i >= warmup:
            times.append(stats.total_time_ms)
    return statistics.median(times), stats.iterations, stats.converged


def audit_phases(op, g, device, reps):
    """{phase: {words_pt, ms, launches}} (module docstring).  At most five fields live at
    once: pass B's chain holds x, r and p."""
    dtype = op.dtype
    alpha = torch.tensor(1e-3, dtype=dtype, device=device)
    beta = torch.tensor(0.5, dtype=dtype, device=device)
    p = field(g, 0, dtype, device)
    runs = {}
    y = torch.empty_like(p)
    runs["spmv_dot"] = lambda: op.run_device_dot(p, out=y)
    x, r, ap = (field(g, seed, dtype, device) for seed in (2, 3, 1))
    runs["update"] = lambda: blas1.cg_update(alpha, x, r, p, ap)
    runs["p_update"] = lambda: blas1.p_update(beta, ap, y)
    runs["recompute_pass_a"] = lambda: op.run_pupdate_dot_op(beta, r, p, out=y)
    runs["recompute_pass_b"] = lambda: op.run_update_recompute_op(alpha, x, r, p)
    phases = {}
    for name, launch in runs.items():
        words, wrapper, counts = PHASES[name]
        before = counts[wrapper] + _launch.REPLAYED.get(wrapper, 0)
        ms = chain_ms(launch, device, wrapper, reps=reps)
        n = counts[wrapper] + _launch.REPLAYED.get(wrapper, 0) - before
        phases[name] = {"words_pt": words, "ms": ms, "launches": n}
        print(f"[audit] {name}: {ms:.4f} ms, {n} launches", file=sys.stderr)
    return phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.audit_cg_iteration",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=20480)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the card's kernels, or their plain twins on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)
    g = args.grid
    info = sysinfo.get_system_info(device)
    print(f"[audit] device {info['device_kind']} ({info.get('nvidia_smi')}), grid {g}",
          file=sys.stderr)

    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=torch.float32, device=device)
    phases = audit_phases(op, g, device, args.reps)
    peak = info["peak_hbm_gbs"]
    for v in phases.values():
        gb = v["words_pt"] * g * g * 4 / 1e9
        v["gbs"] = gb / (v["ms"] / 1e3)
        v["bound_ms"] = gb / peak * 1e3 if peak else None
        v["bound_share"] = v["bound_ms"] / v["ms"] if peak else None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    fixed_ms, _, _ = timed_solve(op, cg.CGConfig(max_iters=0), False, warmup=1, runs=3)
    classic_ms, it_c, conv_c = timed_solve(op, cg.CGConfig(max_iters=100), False,
                                           runs=args.runs)
    recomp_ms, it_r, conv_r = timed_solve(op, cg.CGConfig(max_iters=100), True,
                                          runs=args.runs)
    op.free()
    if not (conv_c and conv_r):
        raise RuntimeError(f"the audit's solves did not converge: classic {conv_c}, "
                           f"recompute {conv_r}")

    def loop(solve_ms, iterations, names, words):
        per_iter = (solve_ms - fixed_ms) / max(iterations, 1)
        phase_sum = sum(phases[k]["ms"] for k in names)
        return {"solve_ms": solve_ms, "iterations": iterations, "per_iter_ms": per_iter,
                "phase_sum_ms": phase_sum, "words_pt_per_iter": words,
                "closure_pct": 100 * phase_sum / per_iter}

    out = {
        "grid": g,
        "mode": "stencil5-const",
        "dtype": "float32",
        "device": info,
        "protocol": "slope between chains of 4 and 16 launches a phase, each a CUDA graph "
                    f"timed by CUDA events (best of {args.reps}); median of {args.runs} "
                    "graph-loop solves; fixed = 0-iteration solve",
        "phases": phases,
        "fixed_overhead_ms": fixed_ms,
        "classic_loop": loop(classic_ms, it_c, CLASSIC, 11),
        "recompute_loop": loop(recomp_ms, it_r, RECOMPUTE, 8),
    }
    path = args.out or os.path.join("results", f"cg_iter_audit_{g}_{device_tag(info)}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "device"}, indent=2))
    print(f"[audit] written: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

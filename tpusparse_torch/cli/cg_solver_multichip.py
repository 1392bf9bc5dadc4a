"""Multi-rank sharded CG solver CLI of the port.

Counterpart of ``tpusparse/cli/cg_solver_multichip.py`` (reference ``cg_solver_mgpu_stencil``,
src/main/cg_solver_mgpu_stencil.cu):

    python -m tpusparse_torch.cli.cg_solver_multichip <gen:<g>|matrix.mtx> [--chips=N]
        [--mode=stencil5] [--tol=1e-6] [--maxiter=1000] [--json=<f>] [--csv=<f>]
        [--runs=10] [--warmup=3] [--dtype=f32|f64] [--timers] [--trace=<logdir>]
        [--multihost] [--platform=cuda|cpu]

``--chips=N`` is the number of ranks (default: one per visible card, one on the CPU).
One command drives them: the CLI spawns N processes on this host
(``dist.launch_local``), rank i on card i % device_count, joined by gloo; with more
ranks than cards the ranks share a card, and rank 0 says so, since their times are then no
measurement of scaling.  Under torchrun (``WORLD_SIZE`` set), with ``--multihost``, or in
a process that already belongs to a group, each process is one rank and the CLI joins
the group instead.  Halo rows and dots pass through the host (``solvers.cg_sharded``).

``gen:<g>`` synthesizes each rank's band on its device; a ``.mtx`` is read by every rank,
which keeps its rows (the reference's per-rank load, :50-60 of its main).  The stencil
modes need a 5-point-stencil-extractable matrix, ``stencil5-const`` uniform coefficients,
``csr`` any g²×g² matrix whose nonzeros lie within one grid row of their row; each of
these refusals returns 2, as ``--dtype=bf16`` (no bf16 state in the port's kernels yet)
and ``--mesh2d`` (the 2-D decomposition is not ported yet) do.

The protocol is the reference's: 3 warm-up solves, 10 timed solves with its statistics,
Sum(x)/Norm2(x) of the solution gathered to rank 0 (``dist.gather_to_host``, timed as
``allgather_ms``), and with several ranks one more solve after a barrier whose per-rank
times give the load imbalance (``dist.rank_time_stats``).  ``--timers`` runs the
host-stepped loop with its halo/SpMV/allreduce/BLAS1 buckets; ``--trace`` profiles one
more solve on rank 0.  The export's ``loop`` is ``recompute-ap`` (``stencil5-const``),
``classic`` or ``host-stepped``.  Only rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist, formats
from .._device import resolve_device, resolve_dtype
from ..bench import export, metrics, profiling, stats, sysinfo
from ..solvers import cg_sharded
from .spmv_bench import load_operand


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.cg_solver_multichip",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix",
                   help=".mtx path (5-point-stencil-extractable for the stencil modes) or "
                        "gen:<grid_size> (each rank synthesizes its band on its device)")
    p.add_argument("--chips", type=int, default=0,
                   help="ranks (default: one per visible card; one on the CPU)")
    p.add_argument("--mode", default="stencil5", choices=list(cg_sharded.MODES),
                   help="SpMV inside the sharded solve; 'csr' is the ELL kernel over each "
                        "band and its halo rows (the role of the reference's in-solver "
                        "csr_spmv_kernel, cg_solver_mgpu_partitioned.cu:40-56)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--json", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64", "bf16"],
                   help="state dtype (default f32); bf16 is refused: no bf16 state yet")
    p.add_argument("--mesh2d", default=None, metavar="RxC",
                   help="2-D block decomposition: refused, not ported yet")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from the torchrun environment (one process "
                        "per rank) instead of spawning the ranks")
    p.add_argument("--timers", action="store_true",
                   help="per-phase timing via the host-stepped sharded loop (adds syncs)")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="profile ONE extra solve on rank 0 into a Chrome trace JSON, "
                        "excluded from the statistics")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the ranks run: the card's kernels, or their plain twins on "
                        "the CPU")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.mesh2d:
        print("[ERROR] --mesh2d: 2-D decomposition is not ported yet (ROADMAP Queue 1 item 7)",
              file=sys.stderr)
        return 2
    if args.dtype == "bf16":
        print("[ERROR] --dtype=bf16: the port's kernels take f32 and f64 state; a bf16 state "
              "is not ported yet (ROADMAP Queue 1 item 8)", file=sys.stderr)
        return 2
    if tdist.is_initialized() or args.multihost or "WORLD_SIZE" in os.environ:
        dist.initialize_multihost()
        if args.chips and args.chips != dist.world_size():
            print(f"[ERROR] --chips={args.chips} but the group has {dist.world_size()} ranks",
                  file=sys.stderr)
            return 2
        return run(args, dist.rank_device(args.platform))
    device = resolve_device(args.platform)  # raises without a card, before any spawn
    nranks = args.chips or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if nranks == 1:
        return run(args, device)
    return dist.launch_local(_rank_main, nranks, argv, device=args.platform)


def _rank_main(device, argv):
    """One spawned rank: the same arguments, this rank's device."""
    return run(build_parser().parse_args(argv), device)


def _load(args, say):
    """(g, planes, matrix, (diag, offdiag) or None, name), or an exit code on a refusal."""
    if args.matrix.startswith("gen:"):
        return int(args.matrix[4:]), None, None, None, None
    mat, name = load_operand(args.matrix)
    if args.mode == "csr":
        g = mat.grid_size or math.isqrt(mat.num_rows)
        if g * g != mat.num_rows:
            say(f"[ERROR] {args.matrix}: {mat.num_rows} rows is not a g² square",
                file=sys.stderr)
            return 2
        return g, None, mat, None, name
    try:
        st = formats.csr_to_stencil5(mat)
    except ValueError as e:
        say(f"[ERROR] {args.matrix} is not 5-point-stencil-extractable ({e}); use "
            "--mode=csr for generic banded matrices", file=sys.stderr)
        return 2
    if args.mode == "stencil5-const" and st.constant is None:
        say(f"[ERROR] {args.matrix} has non-uniform coefficients; stencil5-const requires a "
            "constant field (use --mode=stencil5)", file=sys.stderr)
        return 2
    planes = st.planes if args.mode in ("stencil5", "stencil5-bf16c") else None
    return st.grid_size, planes, None, st.constant, name


def run(args, device) -> int:
    """This rank's part of the CLI: every rank loads, builds its operator and solves;
    rank 0 reports."""
    primary = dist.rank() == 0

    def say(*a, **kw):
        if primary:
            print(*a, **kw)

    loaded = _load(args, say)
    if isinstance(loaded, int):
        return loaded
    g, planes, matrix, const_coeffs, name = loaded
    name = name or f"stencil5-{g}x{g}"
    dtype = resolve_dtype(args.dtype or "f32")
    nranks = dist.world_size()
    info = sysinfo.get_system_info(device)
    sharing = dist.ranks_per_card(device)
    say(f"[INFO] ranks: {nranks} x {info['device_kind']} ({nranks} process(es), gloo)")
    if sharing > 1:
        say(f"[INFO] {sharing} ranks share each card: their kernels take turns on it, so "
            "these times are no measurement of scaling across cards")

    diag, offdiag = const_coeffs if const_coeffs is not None else (5.0, -1.0)
    op = cg_sharded.make_sharded_operator(g, mode=args.mode, planes=planes, matrix=matrix,
                                          diag=diag, offdiag=offdiag, dtype=dtype,
                                          device=device)
    del planes, matrix
    loop = ("host-stepped" if args.timers
            else "recompute-ap" if op.mode == "stencil5-const" else "classic")
    solve = (cg_sharded.cg_solve_sharded_stepped if args.timers
             else cg_sharded.cg_solve_sharded)

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        x, st = solve(g, tolerance=args.tol, max_iters=args.maxiter, dtype=dtype, operator=op)
        ms = (time.perf_counter() - t0) * 1e3
        # the timed payloads keep no solution: a band per run would pile up until the
        # median run is known (cli/cg_solver.py's run_solve)
        return ms, (x if keep_x else None, st)

    bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
        run_solve, num_runs=args.runs, warmup=args.warmup)
    _, (x, _st) = run_solve(keep_x=True)  # deterministic: one more solve gives x

    rank_times = None
    if nranks > 1:  # the reference's MPI_Barrier -> solve -> MAX/MIN (:405, :749-800)
        dist.barrier()
        t_rank = time.perf_counter()
        run_solve()
        rank_times = dist.rank_time_stats(time.perf_counter() - t_rank)
    if args.trace:
        if primary:
            profiling.profiled_run(lambda: run_solve()[1][0], logdir=args.trace)
            print(f"[INFO] trace captured: {args.trace}")
        else:
            run_solve()

    if rank_times is not None:
        say(f"Load imbalance:      {rank_times['load_imbalance_pct']:.2f}% (measured: max "
            f"{rank_times['solve_time_max_ms']:.2f} / min {rank_times['solve_time_min_ms']:.2f}"
            f" ms across {nranks} ranks)")
    else:
        imbalance = 100.0 * op.row_pad / op.band if op.band else 0.0
        say(f"Load imbalance:      {imbalance:.2f}% (row padding {op.row_pad} of band "
            f"{op.band}; one rank)")
    # the MPI_Gatherv analog, timed as the reference's CGStatsMultiGPU time_allgather
    t_gather = time.perf_counter()
    x_host = dist.gather_to_host(x, rows=g)
    allgather_ms = (time.perf_counter() - t_gather) * 1e3
    del x
    cg_sharded.clear_caches()  # a synthesized operand's operator is cached: drop it
    if not primary:
        return 0 if cg_stats.converged else 1
    x_host = np.asarray(x_host, np.float64).ravel()
    gfl = (metrics.cg_gflops(op.nnz, cg_stats.iterations, cg_stats.spmv_time_ms)
           if cg_stats.spmv_time_ms > 0 else None)
    result = export.cg_result_dict(
        # op.mode, not args.mode: a padded stencil5-const runs as stencil5
        solver=f"tpusparse-cg-sharded-{nranks}chip", mode=op.mode, matrix_name=name, op=op,
        cg_stats=cg_stats, bench_stats=bench, sysinfo=info, sum_x=float(x_host.sum()),
        norm2_x=float(np.linalg.norm(x_host)), gflops_spmv=gfl, loop=loop,
        extra_timing={"num_chips": nranks, "allgather_ms": allgather_ms,
                      **({"spmv_kernel": "the ELL kernel (K12/K13's) over each band's "
                          "gather domain, the band and its two halo rows"}
                         if op.mode == "csr" else {}),
                      **(rank_times or {})},
    )
    result["dtype"] = "f64" if dtype == torch.float64 else "f32"
    export.print_human_cg(result)
    if args.json:
        export.write_json(args.json, result)
        print(f"[INFO] JSON written: {args.json}")
    if args.csv:
        export.append_csv(args.csv, result)
    return 0 if cg_stats.converged else 1


if __name__ == "__main__":
    sys.exit(main())

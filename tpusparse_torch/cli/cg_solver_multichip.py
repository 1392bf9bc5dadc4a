"""Multi-rank sharded CG solver CLI of the port.

Counterpart of ``tpusparse/cli/cg_solver_multichip.py`` (reference ``cg_solver_mgpu_stencil``,
src/main/cg_solver_mgpu_stencil.cu):

    python -m tpusparse_torch.cli.cg_solver_multichip <gen:<g>|matrix.mtx> [--chips=N]
        [--mode=stencil5] [--tol=1e-6] [--maxiter=1000] [--json=<f>] [--csv=<f>]
        [--runs=10] [--warmup=3] [--dtype=f32|f64|bf16] [--mesh2d=RxC] [--timers]
        [--trace=<logdir>] [--multihost] [--platform=cuda|cpu]

``--chips=N`` is the number of shards (default: one per visible card, one on the CPU).
This process drives them all over a mesh of devices (``dist.make_band_mesh``), as the JAX
CLI does: shard i on card i % device_count, halos copied from device to device, the dots
summed on the mesh's first device, and on one card the whole solve replayed from one CUDA
graph (``solvers.cg_sharded.MeshOperator``).  With more shards than cards the shards
share a card, and the CLI says so, since their times are then no measurement of scaling.
Under torchrun (``WORLD_SIZE`` set), with ``--multihost``, or in a process that already
belongs to a group, each process is one rank of a group instead (the JAX CLI's multi-host
mode), and ``--chips=N`` is the global count of shards, as in the JAX CLI: N a multiple of
the W ranks, each rank driving a mesh of N / W of them (``dist.make_rank_mesh``: halos
copied device to device within a rank, the rows between ranks and every dot by the
group's transport, its partials added in global shard order), or with ``--chips=0`` (or
N = W) one band a rank.  An N that is not a multiple of W returns 2.  Between ranks whose
cards are all their own the transport is NCCL, card to card; elsewhere (the CPU, ranks
sharing a card) gloo through the host (``dist.device_group``).

``gen:<g>`` synthesizes each shard's band on its device; a ``.mtx`` is read once a
process, and each shard keeps its rows (the reference's per-rank load, :50-60 of its
main).  The stencil
modes need a 5-point-stencil-extractable matrix, ``stencil5-const`` uniform coefficients,
``csr`` any g²×g² matrix whose nonzeros lie within one grid row of their row; each of
these refusals returns 2.  ``--dtype=bf16`` runs a bf16 state through the classic and
stepped loops; ``stencil5-const`` on row bands, whose loop is the recompute one, returns 2
at bf16 without ``--timers`` (the JAX CLI fails there).

``--mesh2d=RxC`` runs the 2-D block decomposition instead (``cg_sharded.
cg_solve_sharded_2d``): an R×C mesh (``--chips`` is ignored, as in the JAX CLI), shard
i·C + j holding grid block (i, j), rows and columns exchanged with its four neighbours.
In a group of W ranks, W = R·C is one block a rank, and W dividing R·C a mesh of R·C / W
blocks a rank (``dist.make_rank_mesh((R, C))``, the JAX CLI's ``--multihost --mesh2d``).
The grid must divide by R and C and the mode be a stencil one; ``csr``, a malformed RxC,
a grid that does not divide, or a group whose size does not divide R·C returns 2.  The
export's solver is ``tpusparse-cg-sharded2d-RxC``.

The protocol is the reference's: 3 warm-up solves, 10 timed solves with its statistics,
Sum(x)/Norm2(x) of the solution (the mesh's shards assembled on its first device, a gloo
group's bands gathered to rank 0, timed as ``allgather_ms``), and with several gloo ranks
one more solve after a barrier whose per-rank times give the load imbalance
(``dist.rank_time_stats``).  ``--timers`` runs the host-stepped loop with its
halo/SpMV/allreduce/BLAS1 buckets; ``--trace`` profiles one more solve (on rank 0), the
program's spans recorded from the start on every rank and summed on rank 0's.  The
export's ``loop`` is ``recompute-ap`` (``stencil5-const``), ``classic`` or
``host-stepped``, with ``-graph`` after the first two where ranks over NCCL run the loop
from CUDA graphs, NCCL's exchanges and sums inside them: one graph a rank where the rank's
shards sit on one card of its own (``solvers.cg_sharded.MeshLoop``; one replay and one
host read a rank a solve, the JAX CLI's one compiled ``while_loop`` a process), one graph
a card where they sit on several (``solvers.cg_sharded.RankCardLoop``, NCCL's calls in
the rank's first card's graph; one replay a card, one read a rank), and its ``topology`` is
``dist.describe_mesh`` of the mesh (transport ``mesh``, or across ranks ``nccl`` or
``gloo``, with its shards and processes) or ``dist.describe_group`` of the group
(transport ``nccl`` or ``gloo``).  Only rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist, formats
from .._device import host_numpy, resolve_device, resolve_dtype
from ..bench import export, metrics, profiling, stats, sysinfo
from ..solvers import cg_sharded
from .spmv_bench import load_operand


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.cg_solver_multichip",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix",
                   help=".mtx path (5-point-stencil-extractable for the stencil modes) or "
                        "gen:<grid_size> (each shard synthesizes its band on its device)")
    p.add_argument("--chips", type=int, default=0,
                   help="shards (default: one per visible card; one on the CPU; in a "
                        "process group one a rank, else a multiple of the ranks)")
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
                   help="state dtype (default f32); bf16 runs the classic and stepped "
                        "loops only")
    p.add_argument("--mesh2d", default=None, metavar="RxC",
                   help="2-D block decomposition over an RxC mesh (R·C shards, --chips "
                        "ignored); the grid must divide both extents")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from the torchrun environment (one gloo "
                        "rank per process) instead of driving a mesh in this process")
    p.add_argument("--timers", action="store_true",
                   help="per-phase timing via the host-stepped sharded loop (adds syncs)")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="profile ONE extra solve on rank 0 into a Chrome trace JSON, "
                        "excluded from the statistics")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the shards run: the cards' kernels, or their plain twins on "
                        "the CPU")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    mesh = None
    if args.mesh2d:
        if args.mode == "csr":
            print("[ERROR] the generic csr mode is 1-D row-band only (reference parity: "
                  "its comparison kernel lives in the 1-D partitioned solver)",
                  file=sys.stderr)
            return 2
        mesh = parse_mesh2d(args.mesh2d)
        if mesh is None:
            print(f"[ERROR] --mesh2d expects RxC (e.g. 2x4), got '{args.mesh2d}'",
                  file=sys.stderr)
            return 2
    if tdist.is_initialized() or args.multihost or "WORLD_SIZE" in os.environ:
        dist.initialize_multihost()
        return _in_group(args, dist.rank_device(args.platform))
    device = resolve_device(args.platform)  # raises without a card
    devices = (dist.make_mesh(mesh, devices=args.platform) if mesh is not None
               else dist.make_band_mesh(args.chips, devices=args.platform))
    return run(args, device, devices)


def parse_mesh2d(text):
    """(R, C) of an ``RxC`` string, both at least 1, or None."""
    try:
        r, c = (int(v) for v in text.lower().split("x"))
    except ValueError:
        return None
    return (r, c) if r >= 1 and c >= 1 else None


def rank_main(device, argv):
    """One rank of a gloo group spawned by ``dist.launch_local(rank_main, n, argv)``: the
    CLI's arguments, this rank's device."""
    return _in_group(build_parser().parse_args(argv), device)


def _in_group(args, device) -> int:
    """This rank's run in a group of W ranks: one band a rank (``--chips`` 0 or W) or one
    block a rank (``--mesh2d=RxC``, R·C = W), else a mesh across the ranks of ``--chips``
    bands or of R·C blocks; 2 when W does not divide them (or a malformed RxC)."""
    w = dist.world_size()
    if args.mesh2d:
        shape = parse_mesh2d(args.mesh2d)
        if shape is None:
            print(f"[ERROR] --mesh2d expects RxC (e.g. 2x4), got '{args.mesh2d}'",
                  file=sys.stderr)
            return 2
        n = shape[0] * shape[1]
        if n == w:
            return run(args, device)
        if n % w:
            print(f"[ERROR] --mesh2d={args.mesh2d} has {n} blocks, not a multiple of the "
                  f"group's {w} ranks", file=sys.stderr)
            return 2
        return run(args, device, dist.make_rank_mesh(shape, devices=args.platform))
    if args.chips in (0, w):
        return run(args, device)
    if args.chips % w:
        print(f"[ERROR] --chips={args.chips} is not a multiple of the group's {w} ranks",
              file=sys.stderr)
        return 2
    return run(args, device, dist.make_rank_mesh(args.chips, devices=args.platform))


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


def run(args, device, mesh=None) -> int:
    """The CLI's solves and report: over ``mesh`` (a ``dist.Mesh``) in this process, or
    as this rank of the gloo group (``mesh`` None; every rank loads, builds its operator
    and solves; rank 0 reports).  ``--trace`` records the program's spans throughout
    (``bench.profiling``), so the trace shows them and rank 0 sums them at the end."""
    if not args.trace:
        return _run(args, device, mesh)
    with profiling.recording():
        return _run(args, device, mesh)


def _run(args, device, mesh) -> int:
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
    info = sysinfo.get_system_info(device)
    if mesh is not None:
        n, sharing, who = mesh.size, mesh.shards_per_card(), "shards"
    else:
        n, sharing, who = dist.world_size(), dist.ranks_per_card(device), "ranks"
    if sharing > 1:
        say(f"[INFO] {sharing} {who} share each card: their kernels take turns on it, so "
            "these times are no measurement of scaling across cards")

    diag, offdiag = const_coeffs if const_coeffs is not None else (5.0, -1.0)
    blocks = parse_mesh2d(args.mesh2d) if args.mesh2d else None
    kw = dict(mode=args.mode, planes=planes, matrix=matrix, diag=diag, offdiag=offdiag,
              dtype=dtype)
    try:
        op = (cg_sharded.make_mesh_operator(g, mesh, **kw) if mesh is not None
              else cg_sharded.make_sharded_operator(g, device=device, mesh_shape=blocks,
                                                    **kw))
    except ValueError as e:
        if blocks is None:
            raise
        say(f"[ERROR] --mesh2d={args.mesh2d}: {e}", file=sys.stderr)
        return 2
    del planes, matrix
    if mesh is None:
        transport = op.halo.transport
        say(f"[INFO] ranks: {n} x {info['device_kind']} ({n} process(es), {transport})")
    else:
        transport = op.link.transport if op.link is not None else "mesh"
        say(f"[INFO] mesh: {n} x {info['device_kind']} ({mesh.processes} process(es)"
            f"{', ' + transport if mesh.processes > 1 else ''})")
    if blocks is not None:
        say(f"[INFO] 2-D mesh {blocks[0]}x{blocks[1]}: shard i·{blocks[1]} + j holds block "
            f"(i, j) of {op.band}x{op.cols}")
    loop = ("host-stepped" if args.timers
            else "recompute-ap" if op.mode == "stencil5-const" and blocks is None
            else "classic")
    ranks_graph = op.rank_graph if mesh is not None else op.halo.group is not None
    if ranks_graph and not args.timers:
        loop += "-graph"  # a graph a rank: the loop with NCCL's calls inside it
    if loop.startswith("recompute-ap") and dtype == torch.bfloat16:
        say("[ERROR] --mode=stencil5-const --dtype=bf16: the row bands' recompute loop "
            "does not take a bf16 state (the JAX CLI fails there too); use --mesh2d, "
            "--timers or --mode=stencil5", file=sys.stderr)
        cg_sharded.clear_caches()
        return 2
    if mesh is not None:
        step = op.solve_stepped if args.timers else op.solve

        def solve():
            return step(tolerance=args.tol, max_iters=args.maxiter)
    else:
        if blocks is not None:
            solve = functools.partial(cg_sharded.cg_solve_sharded_2d_stepped if args.timers
                                      else cg_sharded.cg_solve_sharded_2d, blocks)
        else:
            solve = (cg_sharded.cg_solve_sharded_stepped if args.timers
                     else cg_sharded.cg_solve_sharded)
        solve = functools.partial(solve, g, tolerance=args.tol, max_iters=args.maxiter,
                                  dtype=dtype, operator=op)

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        x, st = solve()
        ms = (time.perf_counter() - t0) * 1e3
        # the timed payloads keep no solution: a band per run would pile up until the
        # median run is known (cli/cg_solver.py's run_solve)
        return ms, (x if keep_x else None, st)

    bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
        run_solve, num_runs=args.runs, warmup=args.warmup)
    _, (x, _st) = run_solve(keep_x=True)  # deterministic: one more solve gives x

    rank_times = None
    if dist.world_size() > 1:  # the reference's MPI_Barrier -> solve -> MAX/MIN
        dist.barrier()
        t_rank = time.perf_counter()
        run_solve()
        rank_times = dist.rank_time_stats(time.perf_counter() - t_rank)
    if args.trace:
        if primary:
            profiling.profiled_run(lambda: run_solve()[1][0], logdir=args.trace)
            print(f"[INFO] trace captured: {args.trace}")
            print(f"[INFO] {profiling.summary()}")
        else:
            run_solve()

    if rank_times is not None:
        say(f"Load imbalance:      {rank_times['load_imbalance_pct']:.2f}% (measured: max "
            f"{rank_times['solve_time_max_ms']:.2f} / min {rank_times['solve_time_min_ms']:.2f}"
            f" ms across {dist.world_size()} ranks)")
    elif blocks is not None:
        say("Load imbalance:      0.00% (2-D blocks divide the grid exactly; one process)")
    else:
        imbalance = 100.0 * op.row_pad / op.band if op.band else 0.0
        say(f"Load imbalance:      {imbalance:.2f}% (row padding {op.row_pad} of band "
            f"{op.band}; one process)")
    # the MPI_Gatherv analog, timed as the reference's CGStatsMultiGPU time_allgather: the
    # mesh's shards assembled on its first device, or the gloo ranks' gathered to rank 0
    t_gather = time.perf_counter()
    if mesh is not None:
        x = op.assemble(x)
        op.sync()
    if blocks is not None and dist.world_size() > 1:
        x = dist.gather_blocks_to_host(x, blocks)
    elif dist.world_size() > 1:
        x = dist.gather_to_host(x, rows=g)
    allgather_ms = (time.perf_counter() - t_gather) * 1e3
    x_host = host_numpy(x) if torch.is_tensor(x) else x
    del x
    topology = (dist.describe_mesh(mesh, transport) if mesh is not None
                else dist.describe_group(device, transport))
    cg_sharded.clear_caches()  # a synthesized operand's operator is cached: drop it
    if not primary:
        return 0 if cg_stats.converged else 1
    x_host = np.asarray(x_host, np.float64).ravel()
    gfl = (metrics.cg_gflops(op.nnz, cg_stats.iterations, cg_stats.spmv_time_ms)
           if cg_stats.spmv_time_ms > 0 else None)
    result = export.cg_result_dict(
        # op.mode, not args.mode: a padded stencil5-const runs as stencil5
        solver=(f"tpusparse-cg-sharded2d-{blocks[0]}x{blocks[1]}" if blocks is not None
                else f"tpusparse-cg-sharded-{n}chip"), mode=op.mode, matrix_name=name,
        op=op,
        cg_stats=cg_stats, bench_stats=bench, sysinfo=info, sum_x=float(x_host.sum()),
        norm2_x=float(np.linalg.norm(x_host)), gflops_spmv=gfl, loop=loop,
        extra_timing={"num_chips": n, "allgather_ms": allgather_ms,
                      **({"spmv_kernel": "the ELL kernel (K12/K13's) over each band's "
                          "gather domain, the band and its two halo rows"}
                         if op.mode == "csr" else {}),
                      **(rank_times or {})},
    )
    result["dtype"] = {torch.float64: "f64", torch.bfloat16: "bf16"}.get(dtype, "f32")
    result["topology"] = topology
    export.print_human_cg(result)
    if args.json:
        export.write_json(args.json, result)
        print(f"[INFO] JSON written: {args.json}")
    if args.csv:
        export.append_csv(args.csv, result)
    return 0 if cg_stats.converged else 1


if __name__ == "__main__":
    sys.exit(main())

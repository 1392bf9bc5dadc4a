"""CG solver CLI of the port.

Counterpart of ``tpusparse/cli/cg_solver.py`` (reference src/main/cg_solver.cu:46-53):

    python -m tpusparse_torch.cli.cg_solver <matrix.mtx|gen:<g>|gen27:<n>> [--mode=stencil5]
        [--tol=1e-6] [--maxiter=1000] [--timers] [--host|--device]
        [--loop=auto|classic|recompute] [--json=<f>] [--csv=<f>] [--runs=10] [--warmup=3]
        [--dtype=f32|f64|bf16] [--trace=<logdir>] [--platform=cuda|cpu]

Modes: stencil5 (the default, the reference's stencil5-csr) and stencil5-bf16c
(coefficient planes in the state's dtype or in bf16, K8; classic loop), stencil5-const
(values-free, K1-K3), and their plain-PyTorch oracles stencil5-xla and stencil5-const-xla;
the generic operators csr (and its alias cusparse-csr, the ELL kernel that replaces
K12/K13), dia (K11), their plain twins csr-xla, ell and dia-xla, and bcoo (cuSPARSE), on
gen:<g> or any square .mtx, classic loop; ``gen27:<n>`` or ``gen27:<nx>x<ny>x<nz>``
is HPCG's 27-point problem (diag 26, offdiag −1), its ELL operand made on the card, which
only csr, cusparse-csr, csr-xla and ell take (``--mode=csr``; any other mode returns 2).
The classic loop's updates run through the
BLAS1 kernels K4-K7.  ``--dtype=bf16`` runs a bf16 state through the classic loop (K3,
K4-K8, K11 and the ELL kernel in their bf16 instances; ``bcoo`` in f32 with x and y
rounded once) and the stepped one; ``--loop=recompute``, and ``--loop=auto`` on
stencil5-const, return 2 there, where the JAX CLI fails.

b = ones, x0 = 0; the device-native loop (``--device``, the default; on a card
``cg.cg_solve`` replays it from a captured CUDA graph, the convergence test on the card, as
the JAX CLI's ran under ``lax.while_loop``): 3 warm-up solves, then 10 timed solves with
the reference's statistics (median, 2σ outlier rejection); Sum(x)/Norm2(x) checksums and,
for the stencil5 modes, the RMS-vs-ones heuristic.
``--timers`` runs the host-stepped classic loop (``cg.cg_solve_stepped``) under the same
statistics, with the SpMV/BLAS1/reduction split of its median run; ``--host`` runs that loop
once untimed and once timed, the reference's host path (cg_solver.cu:172-181).  Either one
makes the export's ``loop`` ``host-stepped``, whatever ``--loop`` says.
``performance.gflops_spmv`` comes from the stepped SpMV time when there is one, else from
the measured time of one SpMV apply (CUDA events).  ``--trace LOGDIR`` profiles one more
solve, excluded from the statistics, and records the program's spans from the start
(``bench.profiling``): the trace shows them as ranges, and the run ends with a line of
their counts and seconds (set-up's and every solve's).  ``--platform=cpu`` runs the
plain PyTorch twins (for tests at small sizes).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import ops
from .._device import host_numpy, resolve_device, resolve_dtype
from ..bench import export, metrics, profiling, stats, sysinfo
from ..solvers import cg
from .spmv_bench import load_operand


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.cg_solver", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix", help=".mtx path, gen:<grid_size>, or gen27:<n> / "
                   "gen27:<nx>x<ny>x<nz> (HPCG's 27-point stencil, --mode=csr)")
    p.add_argument("--mode", default="stencil5", help="SpMV operator "
                   f"({', '.join(ops.available_modes())})")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--timers", action="store_true",
                   help="per-phase timing via the host-stepped loop (adds a sync per phase)")
    p.add_argument("--host", action="store_true",
                   help="host-stepped loop, one timed run (reference --host, "
                        "cg_solver.cu:172-181)")
    p.add_argument("--device", action="store_true",
                   help="device-native loop (the default; reference --device)")
    p.add_argument("--loop", default="auto", choices=["auto", "classic", "recompute"],
                   help="'recompute' = the 8-words/pt recompute-Ap two-pass loop, "
                        "'classic' = the 3-pass loop, 'auto' = recompute when the operator "
                        "provides it.  The export records which one ran.")
    p.add_argument("--json", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                   help="state dtype; bf16 runs the classic and stepped loops only (the "
                        "recompute loop, also --loop=auto's pick on stencil5-const, "
                        "returns 2, as the JAX CLI fails there)")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card's kernels, or their plain twins on the CPU")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="profile ONE extra solve, excluded from the statistics, into a "
                        "Chrome trace JSON in LOGDIR (the reference's cudaProfilerStart/Stop "
                        "run)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.trace:
        return _main(args)
    # the program's spans throughout (bench.profiling): the trace shows them, and the
    # run ends with their sums
    with profiling.recording():
        return _main(args)


def _main(args) -> int:
    if args.host and args.device:
        # argv only: fail before the load and the operator's build
        print("[ERROR] --host and --device are mutually exclusive", file=sys.stderr)
        return 2
    device = resolve_device(args.platform)
    dtype = resolve_dtype(args.dtype)
    mat, name = load_operand(args.matrix)
    try:
        op = ops.get_operator(args.mode, mat, dtype=dtype, device=device)
    except ValueError as e:  # a mode the matrix does not fit
        print(f"[ERROR] {args.matrix}: {e}", file=sys.stderr)
        return 2
    info = sysinfo.get_system_info(device)
    print(f"[INFO] device: {info['device_kind']} x{info['num_devices']} "
          f"(backend={info['backend']}, nvidia-smi: {info.get('nvidia_smi')})")

    recompute_ap = {"auto": None, "classic": False, "recompute": True}[args.loop]
    try:
        recompute = cg.uses_recompute(op, recompute_ap)
    except ValueError:
        print(f"[ERROR] --loop=recompute: mode '{args.mode}' provides no recompute passes "
              "(only stencil5-const does)", file=sys.stderr)
        return 2
    loop_kind = "recompute-ap" if recompute else "fused-classic"
    host_path = args.host or args.timers
    if host_path:
        loop_kind = "host-stepped"  # the stepped loop is the classic one, whatever --loop
        b = op.ones_b()
    else:
        try:
            cg.check_loop(dtype, "recompute" if recompute else "classic")
        except ValueError as e:
            print(f"[ERROR] --loop={args.loop} --dtype={args.dtype}: {e}", file=sys.stderr)
            return 2
    config = cg.CGConfig(max_iters=args.maxiter, tolerance=args.tol, verbose=args.verbose)

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        if host_path:
            x, st = cg.cg_solve_stepped(op.run_device_dot, b, config=config)
        else:
            x, st = cg.cg_solve(op, config=config, b_is_ones=True, recompute_ap=recompute_ap)
        ms = (time.perf_counter() - t0) * 1e3
        # the timed payloads keep no solution: the solve is deterministic, and one more
        # solve after the statistics supplies the checksummed x
        return ms, (x if keep_x else None, st)

    if args.host and not args.timers:
        # the reference's host path: one run, after one untimed warm-up (cg_solver.cu:172-181)
        run_solve()
        ms, (x, cg_stats) = run_solve(keep_x=True)
        bench = stats.BenchmarkStats(mean_ms=ms, std_ms=0.0, median_ms=ms, min_ms=ms,
                                     max_ms=ms, total_runs=1, valid_runs=1,
                                     outliers_removed=0, times_ms=[ms], median_run_index=0)
    else:
        bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
            run_solve, num_runs=args.runs, warmup=args.warmup)
        _, (x, _st) = run_solve(keep_x=True)
    if args.trace:
        profiling.profiled_run(run_solve, logdir=args.trace)
        print(f"[INFO] trace captured: {args.trace}")
        print(f"[INFO] {profiling.summary()}")
    x_host = host_numpy(op.from_field(x)).astype(np.float64)  # checksums in f64
    del x

    # gflops_spmv from a measurement only: the stepped loop's SpMV time, else the device
    # time of one SpMV apply
    extra_timing = None
    if cg_stats.spmv_time_ms > 0:
        spmv_ms_total = cg_stats.spmv_time_ms
    else:
        spmv_kernel_ms = op.kernel_time_ms()
        spmv_ms_total = spmv_kernel_ms * max(cg_stats.iterations, 1)
        extra_timing = {"spmv_kernel_ms_per_apply": spmv_kernel_ms}
    gfl = metrics.cg_gflops(op.nnz, cg_stats.iterations, spmv_ms_total)
    result = export.cg_result_dict(
        solver="tpusparse_torch-cg", mode=args.mode, matrix_name=name, op=op,
        cg_stats=cg_stats, bench_stats=bench, sysinfo=info,
        sum_x=float(x_host.sum()), norm2_x=float(np.linalg.norm(x_host)),
        gflops_spmv=gfl, extra_timing=extra_timing, loop=loop_kind,
    )
    result["dtype"] = args.dtype
    export.print_human_cg(result)

    # interior rows of the stencil sum to diag + 4·offdiag = 1, so x ≈ 1 away from the
    # boundary (the reference's RMS heuristic, cg_solver.cu:187-192); printed, not gated,
    # and only for the stencil modes, as the JAX CLI does
    if args.verbose >= 1 and args.mode.startswith("stencil5"):
        rms = float(np.sqrt(np.mean((x_host - 1.0) ** 2)))
        print(f"RMS error vs x≈1 heuristic: {rms:.6f}")
    if not cg_stats.converged:
        print("[WARN] solver did not converge", file=sys.stderr)
    if args.json:
        export.write_json(args.json, result)
        print(f"[INFO] JSON written: {args.json}")
    if args.csv:
        export.append_csv(args.csv, result)
    return 0 if cg_stats.converged else 1


if __name__ == "__main__":
    sys.exit(main())

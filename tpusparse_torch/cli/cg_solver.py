"""CG solver CLI of the port.

Counterpart of ``tpusparse/cli/cg_solver.py`` (reference src/main/cg_solver.cu:46-53):

    python -m tpusparse_torch.cli.cg_solver <matrix.mtx|gen:<g>> [--mode=stencil5-const]
        [--tol=1e-6] [--maxiter=1000] [--loop=auto|classic|recompute] [--json=<f>]
        [--csv=<f>] [--runs=10] [--warmup=3] [--dtype=f32|f64] [--device=cuda|cpu]

Modes: stencil5-const (values-free, K1-K3), stencil5 and stencil5-bf16c (coefficient
planes in the state's dtype or in bf16, K8; classic loop), and their plain-PyTorch
oracles stencil5-const-xla and stencil5-xla; the generic operators csr (and its alias
cusparse-csr, the ELL kernel that replaces K12/K13), dia (K11), their plain twins csr-xla,
ell and dia-xla, and bcoo (cuSPARSE), on gen:<g> or any square .mtx, classic loop.  The
classic loop's updates run through the BLAS1 kernels K4-K7.

b = ones, x0 = 0; 3 warm-up solves, then 10 timed solves with the reference's statistics
(median, 2σ outlier rejection); Sum(x)/Norm2(x) checksums and, for the stencil5 modes, the
RMS-vs-ones heuristic;
``performance.gflops_spmv`` from the measured time of one SpMV apply (CUDA events).
``--device=cpu`` runs the plain PyTorch twins (for tests at small sizes).  The JAX CLI's
``--timers``, ``--host`` and ``--trace`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tpusparse.bench import export, metrics, stats
from tpusparse.cli.spmv_bench import load_operand

from .. import ops
from .._device import resolve_device, resolve_dtype
from ..bench import sysinfo
from ..solvers import cg


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.cg_solver", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix", help=".mtx path, or gen:<grid_size>")
    p.add_argument("--mode", default="stencil5-const", help="SpMV operator "
                   f"({', '.join(ops.available_modes())})")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--loop", default="auto", choices=["auto", "classic", "recompute"],
                   help="'recompute' = the 8-words/pt recompute-Ap two-pass loop, "
                        "'classic' = the 3-pass loop, 'auto' = recompute when the operator "
                        "provides it.  The export records which one ran.")
    p.add_argument("--json", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--verbose", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    mat, name = load_operand(args.matrix)
    op = ops.get_operator(args.mode, mat, dtype=dtype, device=device)
    info = sysinfo.get_system_info(device)
    print(f"[INFO] device: {info['device_kind']} x{info['num_devices']} "
          f"(backend={info['backend']}, nvidia-smi: {info.get('nvidia_smi')})")

    recompute_ap = {"auto": None, "classic": False, "recompute": True}[args.loop]
    try:
        loop_kind = "recompute-ap" if cg.uses_recompute(op, recompute_ap) else "fused-classic"
    except ValueError:
        print(f"[ERROR] --loop=recompute: mode '{args.mode}' provides no recompute passes "
              "(only stencil5-const does)", file=sys.stderr)
        return 2
    config = cg.CGConfig(max_iters=args.maxiter, tolerance=args.tol, verbose=args.verbose)

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        x, st = cg.cg_solve(op, config=config, b_is_ones=True, recompute_ap=recompute_ap)
        ms = (time.perf_counter() - t0) * 1e3
        # the timed payloads keep no solution: the solve is deterministic, and one more
        # solve after the statistics supplies the checksummed x
        return ms, (x if keep_x else None, st)

    bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
        run_solve, num_runs=args.runs, warmup=args.warmup)
    _, (x, _st) = run_solve(keep_x=True)
    x_host = op.from_field(x).cpu().numpy().astype(np.float64)
    del x

    # gflops_spmv from a measurement only: the device time of one SpMV apply
    spmv_kernel_ms = op.kernel_time_ms()
    gfl = metrics.cg_gflops(op.nnz, cg_stats.iterations,
                            spmv_kernel_ms * max(cg_stats.iterations, 1))
    result = export.cg_result_dict(
        solver="tpusparse_torch-cg", mode=args.mode, matrix_name=name, op=op,
        cg_stats=cg_stats, bench_stats=bench, sysinfo=info,
        sum_x=float(x_host.sum()), norm2_x=float(np.linalg.norm(x_host)),
        gflops_spmv=gfl, extra_timing={"spmv_kernel_ms_per_apply": spmv_kernel_ms},
        loop=loop_kind,
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

"""The port's headline benchmark: the counterpart of the repo's ``bench.py``.

    python -m tpusparse_torch.bench.headline [--metric=cg|spmv]

Prints exactly one JSON line on stdout, ``{"metric": ..., "value": ..., "unit": ...,
"vs_baseline": ..., ...}``; its progress goes to stderr.

``--metric=cg`` (the default, ``bench_cg``): CG time to solution at 20480² (419M unknowns,
tol 1e-6, b = ones, x0 = 0) on the values-free ``stencil5-const`` operator in f32, against
the reference's largest published single-GPU solve (20000², 531.4 ms on one A100 in f64,
``BASELINE.md``): ``vs_baseline`` = 531.4 / the port's median.  It times the classic loop
(K3, K4, K5, K6), then the recompute-Ap loop (K1, K2, K6), each solve a replay of the
graph loop (``solvers/cg.DeviceLoop``), with the reference's statistics
(``bench.stats.compute_stats``: warm-ups discarded, 2σ rejection, median of the valid
runs); the headline is the faster loop, and ``loop`` names it: ``"recompute-ap"`` or
``"classic"`` (``bench.py`` calls the same classic loop ``"fused-classic"``).  Then the
values-carrying companion: ``stencil5-bf16c`` (bf16 planes made on the card, f32 state,
K8, K4, K5, K6), reported as ``values_carrying_bf16c_ms``.  Every solve must converge in
exactly ``--expect-iterations`` (14 at 20480²), else RuntimeError.

``--metric=spmv`` (``bench_spmv``): K8 (``kernels.stencil5.spmv_stencil5``) on f32 planes
at 10240², gated on the analytic checksum of A·ones to 1e-3, timed by the paired-chain
slope of 6 and 24 applies (each chain one CUDA graph, timed around its replay, best of 3:
``bench.probes``' helpers), reported as its share of the card's data-sheet HBM rate for
7·g²·4 bytes an apply (``sysinfo.gpu_peaks``), ``vs_baseline`` = share / 0.95 (the
reference's 95%-of-roofline claim).  A card missing from the table raises.

Unlike ``bench.py``, everything runs in this one process and nothing here catches an
exception: a loop, the companion or a kernel build that fails ends the run non-zero with
its traceback, and no other metric stands in.  ``--platform`` defaults to cuda and raises
without a card; ``--platform=cpu``, ``--grid``, ``--warmup``, ``--runs`` and
``--expect-iterations`` exist for the CPU tests, where the kernels' plain twins run;
``--metric=spmv`` raises on the CPU, which has no peak rate.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import generate, ops
from .._device import resolve_device
from ..formats import Stencil5
from ..kernels import stencil5 as st5
from ..solvers import cg
from . import stats, sysinfo
from .probes import _chain, _timed_best, slope_seconds

CG_GRID = 20480
SPMV_GRID = 10240
REF_20K_MS = 531.4  # the reference's CG at 20000², one A100-SXM, f64 (BASELINE.md)
REF_ITERS = 14
CG_UNIT = f"ms_median_stencil5-const_f32_vs_a100_f64_csr_{REF_20K_MS}"
REF_ROOFLINE = 0.95  # the reference's claimed share of the HBM roofline
DIAG, OFFDIAG = 5.0, -1.0
CHECKSUM_TOL = 1e-3
CHAIN = (6, 24)  # applies in the short and the long chain of the slope
CHAIN_REPS = 3


def _log(msg: str) -> None:
    print(f"[headline] {msg}", file=sys.stderr, flush=True)


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return sysinfo.nvidia_smi() or f"{torch.cuda.get_device_name(device)}, power limit unread"


def cg_metric(g: int) -> str:
    """The CG metric's name: ``bench.py``'s at 20480², the same form at another grid."""
    n = g * g
    unknowns = f"{n // 10 ** 6}M" if n >= 10 ** 6 else str(n)
    return f"cg_{g}sq_{unknowns}_unknowns_time_ms_stencil5-const_f32"


def run_solves(op, label, config, warmup, runs, expect_iterations, recompute_ap=None):
    """``warmup`` + ``runs`` solves of b = ones; the statistics of the timed ones.  Raises
    RuntimeError when a solve does not converge or takes other than
    ``expect_iterations``."""
    times = []
    for i in range(warmup + runs):
        x, st = cg.cg_solve(op, config=config, b_is_ones=True, recompute_ap=recompute_ap)
        del x  # a held x makes the next solve capture a new slot of the graph loop
        if not st.converged:
            raise RuntimeError(f"CG did not converge ({label}): {st}")
        if st.iterations != expect_iterations:
            raise RuntimeError(f"iteration-count parity broken ({label}): {st.iterations} "
                               f"!= {expect_iterations}")
        if i >= warmup:
            times.append(st.total_time_ms)
    return stats.compute_stats(times)


def bench_cg(grid=CG_GRID, device="cuda", warmup=3, runs=10,
             expect_iterations=REF_ITERS) -> dict:
    """The CG headline (``bench.py:28-130``): returns its JSON line as a dict, with
    ``bench.py``'s keys and ``device``.  ``vs_baseline`` compares with the reference's
    20000² solve whatever ``grid`` is."""
    dev = resolve_device(device)
    g = int(grid)
    card = _card(dev)
    config = cg.CGConfig(max_iters=100, tolerance=1e-6)
    op = ops.get_operator("stencil5-const", Stencil5(g, None, (DIAG, OFFDIAG)),
                          dtype=torch.float32, device=dev)
    common = (config, warmup, runs, expect_iterations)
    classic = run_solves(op, "stencil5-const classic", *common, recompute_ap=False)
    _log(f"cg {g}^2 stencil5-const f32 (classic loop): median {classic.median_ms!r} ms "
         f"[{card}]")
    recompute = run_solves(op, "stencil5-const recompute", *common, recompute_ap=True)
    _log(f"cg {g}^2 stencil5-const f32 (recompute-ap loop): median "
         f"{recompute.median_ms!r} ms [{card}]")
    op.free()
    best, loop = ((recompute, "recompute-ap") if recompute.median_ms < classic.median_ms
                  else (classic, "classic"))
    _log(f"cg {g}^2 stencil5-const f32: median {best.median_ms!r} ms ({loop}), "
         f"{expect_iterations} iterations (ref A100 f64: {REF_20K_MS} ms) [{card}]")

    # the values-carrying companion: the operator makes its bf16 planes on the card
    # (generate.make_stencil5_planes_device, bf16 filled directly)
    op2 = ops.get_operator("stencil5-bf16c", Stencil5(g, None, (DIAG, OFFDIAG)),
                           dtype=torch.float32, device=dev)
    bf16c = run_solves(op2, "stencil5-bf16c", *common)
    op2.free()
    _log(f"cg {g}^2 stencil5-bf16c (values-carrying): median {bf16c.median_ms!r} ms "
         f"[{card}]")
    return {
        "metric": cg_metric(g),
        "value": best.median_ms,
        "unit": CG_UNIT,
        "vs_baseline": REF_20K_MS / best.median_ms,
        "mode": "stencil5-const",
        "loop": loop,
        "classic_loop_ms": classic.median_ms,
        "dtype": "float32",
        "iterations": expect_iterations,
        "total_runs": best.total_runs,
        "valid_runs": best.valid_runs,
        "std_ms": best.std_ms,
        "values_carrying_bf16c_ms": bf16c.median_ms,
        "vs_baseline_bf16c": REF_20K_MS / bf16c.median_ms,
        "device": card,
    }


def spmv_bytes(g: int) -> int:
    """K8's bytes an f32 apply: five planes and x read, y written."""
    return 7 * g * g * 4


def check_spmv(planes, g: int) -> float:
    """K8 on x = ones against the analytic Sum(y) (``generate.stencil5_spmv_checksums``);
    returns the relative error, RuntimeError above ``CHECKSUM_TOL``."""
    x = torch.ones((g, g), dtype=planes.dtype, device=planes.device)
    got = float(st5.spmv_stencil5(planes, x).sum(dtype=torch.float64))
    want, _ = generate.stencil5_spmv_checksums(g, DIAG, OFFDIAG)
    err = abs(got - want) / abs(want)
    if not err <= CHECKSUM_TOL:
        raise RuntimeError(f"K8 checksum mismatch at {g}^2: Sum(y) {got!r} against "
                           f"{want!r} (rel {err:.3e} > {CHECKSUM_TOL:g})")
    return err


def spmv_inputs(g: int, device):
    """K8's operands in ``bench_spmv``: the f32 planes made on the device and x drawn
    from N(0, 1) with seed 0."""
    planes = generate.make_stencil5_planes_device(g, DIAG, OFFDIAG, dtype=torch.float32,
                                                  device=device)
    x = torch.randn((g, g), generator=torch.Generator(device).manual_seed(0), device=device)
    return planes, x


def bench_spmv(grid=SPMV_GRID, device="cuda") -> dict:
    """The SpMV metric (``bench.py:133-190``): K8's share of the card's HBM peak."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak_gbs, _ = sysinfo.gpu_peaks(kind)
    if peak_gbs is None:
        raise RuntimeError(f"no HBM peak rate for device {kind!r} in sysinfo.GPU_SPECS")
    g = int(grid)
    card = _card(dev)
    planes, x = spmv_inputs(g, dev)
    err = check_spmv(planes, g)
    y = torch.empty_like(x)
    nbytes = spmv_bytes(g)

    def one_apply():
        st5.spmv_stencil5(planes, x, out=y)

    k_lo, k_hi = CHAIN
    t_lo = _timed_best(_chain(one_apply, k_lo, dev, nbytes), CHAIN_REPS, dev)
    t_hi = _timed_best(_chain(one_apply, k_hi, dev, nbytes), CHAIN_REPS, dev)
    per_apply = slope_seconds(t_lo, t_hi, k_lo, k_hi)
    gbs = nbytes / per_apply / 1e9
    frac = gbs / peak_gbs
    _log(f"stencil5 spmv {g}^2 f32: checksum rel err {err:.3e}; {per_apply * 1e3!r} "
         f"ms/apply (slope of {k_lo} and {k_hi}), {gbs!r} GB/s, {100 * frac:.2f}% of "
         f"{peak_gbs:g} GB/s [{card}]")
    return {
        "metric": "stencil5_spmv_hbm_roofline_fraction",
        "value": frac,
        "unit": "fraction_of_chip_hbm_peak",
        "vs_baseline": frac / REF_ROOFLINE,
        "ms_per_apply": per_apply * 1e3,
        "grid": g,
        "device": card,
    }


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.headline", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metric", default="cg", choices=["cg", "spmv"])
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="the card's kernels, or their plain twins on the CPU (tests)")
    p.add_argument("--grid", type=int, default=None,
                   help=f"grid size (default {CG_GRID} for cg, {SPMV_GRID} for spmv)")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--expect-iterations", type=int, default=REF_ITERS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    if args.metric == "cg":
        result = bench_cg(args.grid or CG_GRID, device, args.warmup, args.runs,
                          args.expect_iterations)
    else:
        result = bench_spmv(args.grid or SPMV_GRID, device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

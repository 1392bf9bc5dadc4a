"""JSON/CSV result exporters of the port: its own copy of ``tpusparse/bench/export.py``.

Schema parity with the reference (SURVEY.md §2.5): SpMV JSON has gpu/system provenance,
benchmark{matrix{}, performance{}, analysis{}, validation{sum_y, norm2_y}}
(spmv_metrics.cu:190-276); CG JSON has timestamp, solver, mode, matrix{}, convergence{},
timing{}, statistics{}, performance{}, validation{} (cg_metrics.cu:20-150).  CSV is append-mode
with a header-once flag (cg_metrics.cu:155-185).  Field names kept compatible where sensible so
the reference's jq/grep-based aggregation scripts port over.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
from typing import Any, Dict, Optional

from .metrics import SpmvMetrics
from .stats import BenchmarkStats


def _now_iso() -> str:
    return datetime.datetime.now().astimezone().isoformat(timespec="seconds")


def spmv_result_dict(*, mode: str, matrix_name: str, op, metrics: SpmvMetrics,
                     stats: BenchmarkStats, sysinfo: Dict[str, Any],
                     sum_y: float, norm2_y: float,
                     kernel_ms: float = 0.0,
                     run_protocol: str = "transfer-inclusive") -> Dict[str, Any]:
    return {
        "timestamp": _now_iso(),
        "benchmark_type": "spmv",
        "device": sysinfo,
        "benchmark": {
            "mode": mode,
            # what the run-time distribution below measures: "transfer-inclusive" wraps
            # per-run H2D/D2H (strict wall protocol); "device-resident" is the
            # reference's run-loop shape (upload once, cudaEvent-style timed applies,
            # read back once — spmv_cusparse_csr.cu:234-264).  kernel-time metrics are
            # chained-slope device time under either protocol.
            "run_protocol": run_protocol,
            "matrix": {
                "name": matrix_name,
                "rows": op.num_rows,
                "cols": op.num_cols,
                "nnz": op.nnz,
                "grid_size": op.grid_size,
            },
            "performance": {
                "time_median_ms": stats.median_ms,
                # device-only kernel time (chained-launch protocol; reference methodology:
                # cudaEvents wrap the kernel, not the transfers) — basis of gflops/bandwidth
                "time_kernel_ms": kernel_ms or stats.median_ms,
                "time_mean_ms": stats.mean_ms,
                "time_std_ms": stats.std_ms,
                "time_min_ms": stats.min_ms,
                "time_max_ms": stats.max_ms,
                "gflops": metrics.gflops,
                "bandwidth_gbs": metrics.bandwidth_gbs,
                "roofline_fraction": metrics.roofline_fraction,
                **(
                    {
                        # measured streaming ceiling (bench.probes) and the fraction of it —
                        # present only when a probe actually ran this session
                        "achievable_gbs": metrics.achievable_gbs,
                        "roofline_fraction_achievable":
                            metrics.roofline_fraction_achievable,
                    }
                    if metrics.roofline_fraction_achievable is not None
                    else {}
                ),
                "dtype": metrics.dtype,
                # non-empty ⇒ the bandwidth/GFLOPS above are NOT valid roofline claims
                # (sub-ms slope noise or >100%-of-peak impossibility); see
                # metrics.MIN_VALID_KERNEL_MS
                **({"timing_flags": list(metrics.timing_flags)}
                   if getattr(metrics, "timing_flags", ()) else {}),
            },
            "statistics": {
                "total_runs": stats.total_runs,
                "valid_runs": stats.valid_runs,
                "outliers_removed": stats.outliers_removed,
                "cv_percent": stats.cv_percent,
            },
            "analysis": {
                "arithmetic_intensity": metrics.arithmetic_intensity,
                "bound_classification": metrics.bound,
                "bytes_per_spmv": metrics.bytes_moved,
            },
            "validation": {"sum_y": sum_y, "norm2_y": norm2_y},
        },
    }


def cg_result_dict(*, solver: str, mode: str, matrix_name: str, op, cg_stats,
                   bench_stats: Optional[BenchmarkStats], sysinfo: Dict[str, Any],
                   sum_x: float, norm2_x: float,
                   gflops_spmv: Optional[float] = None,
                   extra_timing: Optional[Dict[str, float]] = None,
                   loop: Optional[str] = None) -> Dict[str, Any]:
    """``gflops_spmv=None`` OMITS performance.gflops_spmv: the field exists only when the
    SpMV phase time was actually measured — never derived from an invented share.
    ``loop`` records which iteration structure actually executed (e.g. "recompute-ap",
    "fused-classic", "host-stepped") so artifacts are self-describing about the program
    that produced them."""
    timing = {
        "total_median_ms": bench_stats.median_ms if bench_stats else cg_stats.total_time_ms,
        "total_mean_ms": bench_stats.mean_ms if bench_stats else cg_stats.total_time_ms,
        "total_min_ms": bench_stats.min_ms if bench_stats else cg_stats.total_time_ms,
        "total_max_ms": bench_stats.max_ms if bench_stats else cg_stats.total_time_ms,
        "total_std_ms": bench_stats.std_ms if bench_stats else 0.0,
        "spmv_ms": cg_stats.spmv_time_ms,
        "blas1_ms": cg_stats.blas1_time_ms,
        "reductions_ms": cg_stats.reduction_time_ms,
        # per-collective timers (reference CGStatsMultiGPU time_allreduce/time_halo,
        # cg_solver_mgpu.h:55-67); zero in single-chip runs
        "halo_ms": getattr(cg_stats, "halo_time_ms", 0.0),
        "allreduce_ms": getattr(cg_stats, "allreduce_time_ms", 0.0),
    }
    # stepped runs: the measured per-call dispatch floors ALREADY subtracted from the
    # phase buckets above (bench.probes.dispatch_baselines) — recorded so the artifact
    # is self-describing about the correction
    if getattr(cg_stats, "dispatch_block_ms", 0.0) or getattr(
            cg_stats, "dispatch_readback_ms", 0.0):
        timing["dispatch_block_ms_per_call"] = cg_stats.dispatch_block_ms
        timing["dispatch_readback_ms_per_call"] = cg_stats.dispatch_readback_ms
        # buckets exported as exactly 0.0 because their raw time fell BELOW the dispatch
        # floor — "unresolvable beneath the launch floor", not "no time spent"
        clipped = getattr(cg_stats, "dispatch_clipped", ())
        if clipped:
            timing["dispatch_clipped_buckets"] = ",".join(clipped)
    if extra_timing:
        timing.update(extra_timing)
    return {
        "timestamp": _now_iso(),
        "benchmark_type": "cg",
        "solver": solver,
        "mode": mode,
        **({"loop": loop} if loop else {}),
        "device": sysinfo,
        "matrix": {
            "name": matrix_name,
            "rows": op.num_rows,
            "cols": op.num_cols,
            "nnz": op.nnz,
            "grid_size": op.grid_size,
        },
        "convergence": {
            "converged": bool(cg_stats.converged),
            "iterations": int(cg_stats.iterations),
            "residual_norm": float(cg_stats.residual_norm),
            "relative_residual": float(cg_stats.relative_residual),
        },
        "timing": timing,
        "statistics": (
            {
                "total_runs": bench_stats.total_runs,
                "valid_runs": bench_stats.valid_runs,
                "outliers_removed": bench_stats.outliers_removed,
            }
            if bench_stats
            else {}
        ),
        "performance": ({"gflops_spmv": gflops_spmv} if gflops_spmv is not None else {}),
        "validation": {"solution_sum": sum_x, "solution_norm": norm2_x},
    }


def write_json(path: str, result: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, (list, tuple)):
            continue
        else:
            out[key] = v
    return out


def append_csv(path: str, result: Dict[str, Any]) -> None:
    """Append-mode CSV with header written once (reference cg_metrics.cu:155-185).

    When appending to an existing file, rows are written against ITS header (extra new
    fields dropped, missing ones blank) so schema evolution can never silently shift
    columns mid-file."""
    flat = _flatten(result)
    exists = os.path.exists(path) and os.path.getsize(path) > 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fieldnames = list(flat)
    if exists:
        with open(path, newline="") as f:
            existing = next(csv.reader(f), None)
        if existing:
            fieldnames = existing
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore",
                                restval="")
        if not exists:
            writer.writeheader()
        writer.writerow(flat)


def print_human_spmv(result: Dict[str, Any]) -> None:
    """Human report with the reference's fixed sections (=== SpMV Performance Metrics ===,
    === Output Checksum ===; SURVEY.md §5.5)."""
    b = result["benchmark"]
    p = b["performance"]
    print("=== SpMV Performance Metrics ===")
    print(f"Mode:                {b['mode']}")
    m = b["matrix"]
    print(f"Matrix:              {m['name']} ({m['rows']}x{m['cols']}, nnz={m['nnz']})")
    print(f"Median time:         {p['time_median_ms']:.3f} ms "
          f"(mean {p['time_mean_ms']:.3f} ± {p['time_std_ms']:.3f})")
    if p.get("time_kernel_ms") and p["time_kernel_ms"] != p["time_median_ms"]:
        print(f"Kernel time:         {p['time_kernel_ms']:.3f} ms "
              f"(device-only, chained; basis of GFLOPS/bandwidth)")
    print(f"Throughput:          {p['gflops']:.2f} GFLOPS")
    share = ("no peak for this device" if p["roofline_fraction"] is None
             else f"{100 * p['roofline_fraction']:.1f}% of nominal HBM roofline")
    print(f"Bandwidth:           {p['bandwidth_gbs']:.1f} GB/s ({share})")
    if p.get("roofline_fraction_achievable") is not None:
        print(f"                     {100 * p['roofline_fraction_achievable']:.1f}% of "
              f"measured-achievable ceiling ({p['achievable_gbs']:.1f} GB/s, probe-backed)")
    for flag in p.get("timing_flags", ()):
        print(f"  [TIMING-VALIDITY] {flag}")
    a = b["analysis"]
    print(f"Arithmetic intensity: {a['arithmetic_intensity']:.3f} FLOP/byte "
          f"[{a['bound_classification']}]")
    s = b["statistics"]
    print(f"Runs:                {s['valid_runs']}/{s['total_runs']} valid "
          f"({s['outliers_removed']} outliers removed)")
    v = b["validation"]
    print("=== Output Checksum ===")
    print(f"Sum(y)   = {v['sum_y']:.16f}")
    print(f"Norm2(y) = {v['norm2_y']:.16f}")


def print_human_cg(result: Dict[str, Any]) -> None:
    c = result["convergence"]
    t = result["timing"]
    print("=== CG Solver Results ===")
    print(f"Solver:     {result['solver']}  (mode={result['mode']})")
    m = result["matrix"]
    print(f"Matrix:     {m['name']} ({m['rows']} unknowns, nnz={m['nnz']})")
    print(f"Converged:  {'YES' if c['converged'] else 'NO'}")
    print(f"Iterations: {c['iterations']}")
    print(f"Residual:   {c['residual_norm']:e} (rel {c['relative_residual']:e})")
    print(f"Time:       median {t['total_median_ms']:.2f} ms "
          f"[min {t['total_min_ms']:.2f}, max {t['total_max_ms']:.2f}]")
    if t.get("spmv_ms"):
        tot = max(t["total_median_ms"], 1e-12)
        print(f"  SpMV:     {t['spmv_ms']:.2f} ms ({100 * t['spmv_ms'] / tot:.0f}%)")
        print(f"  BLAS1:    {t['blas1_ms']:.2f} ms ({100 * t['blas1_ms'] / tot:.0f}%)")
        if t.get("reductions_ms") and not t.get("allreduce_ms"):
            # single-chip reductions; in sharded runs the Allreduce line IS this bucket
            print(f"  Reduce:   {t['reductions_ms']:.2f} ms "
                  f"({100 * t['reductions_ms'] / tot:.0f}%)")
        if t.get("halo_ms"):
            print(f"  Halo:     {t['halo_ms']:.2f} ms ({100 * t['halo_ms'] / tot:.0f}%)  "
                  f"[D2H, gloo, H2D]")
        if t.get("allreduce_ms"):
            print(f"  Allreduce:{t['allreduce_ms']:.2f} ms "
                  f"({100 * t['allreduce_ms'] / tot:.0f}%)  [dot reads + gloo gather]")
    v = result["validation"]
    print("=== Solution Checksum ===")
    print(f"Sum(x)   = {v['solution_sum']:.16f}")
    print(f"Norm2(x) = {v['solution_norm']:.16f}")

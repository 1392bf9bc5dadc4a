"""Statistical benchmarking engine of the port: its own copy of ``tpusparse/bench/stats.py``.

Exact protocol parity with the reference (src/spmv/benchmark_stats.cu:39-89):
  1. run the workload N times (default 10) after W warmups (5 for SpMV, 3 for CG —
     main.cu:158-162 / cg_solver.cu:154-165),
  2. compute mean/std over all runs,
  3. drop outliers beyond 2σ,
  4. recompute mean/std/median/min/max over the valid runs,
  5. require ≥3 valid runs (benchmark_stats.cu:55-57),
  6. for CG-style workloads, report the per-phase stats of the MEDIAN-time run, not averages
     (benchmark_stats.cu:169-170).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np

OUTLIER_SIGMA = 2.0
MIN_VALID_RUNS = 3


@dataclasses.dataclass
class BenchmarkStats:
    """Parity with reference BenchmarkStats (include/benchmark_stats.h)."""

    mean_ms: float
    std_ms: float
    median_ms: float
    min_ms: float
    max_ms: float
    total_runs: int
    valid_runs: int
    outliers_removed: int
    times_ms: List[float]
    median_run_index: int  # index (into the original run list) of the median-time valid run

    @property
    def cv_percent(self) -> float:
        return 100.0 * self.std_ms / self.mean_ms if self.mean_ms else 0.0


def compute_stats(times_ms) -> BenchmarkStats:
    times = np.asarray(times_ms, dtype=np.float64)
    n = times.shape[0]
    if n < MIN_VALID_RUNS:
        raise ValueError(f"need >= {MIN_VALID_RUNS} runs, got {n}")
    mean0 = times.mean()
    std0 = times.std()
    keep = np.abs(times - mean0) <= OUTLIER_SIGMA * std0 if std0 > 0 else np.ones(n, bool)
    if keep.sum() < MIN_VALID_RUNS:
        keep = np.ones(n, bool)  # degenerate: keep everything rather than fail
    valid = times[keep]
    valid_idx = np.flatnonzero(keep)
    median = float(np.median(valid))
    # the valid run whose time is closest to the median (even count ⇒ no exact median run)
    med_pos = int(np.argmin(np.abs(valid - median)))
    return BenchmarkStats(
        mean_ms=float(valid.mean()),
        std_ms=float(valid.std()),
        median_ms=median,
        min_ms=float(valid.min()),
        max_ms=float(valid.max()),
        total_runs=n,
        valid_runs=int(keep.sum()),
        outliers_removed=int(n - keep.sum()),
        times_ms=[float(t) for t in times],
        median_run_index=int(valid_idx[med_pos]),
    )


def benchmark_with_stats(run_timed: Callable[[], float], *, num_runs: int = 10,
                         warmup: int = 5) -> BenchmarkStats:
    """Reference benchmark_with_stats: warmups discarded, N timed runs, outlier-robust stats.

    ``run_timed`` returns the elapsed milliseconds of one fully synchronized run."""
    for _ in range(warmup):
        run_timed()
    times = [run_timed() for _ in range(num_runs)]
    return compute_stats(times)


def benchmark_solver_with_stats(run_solve: Callable[[], tuple], *, num_runs: int = 10,
                                warmup: int = 3):
    """Reference cg_benchmark_with_stats_device (benchmark_stats.cu:92-177): N full solves,
    stats over total time, and the per-run payload (CGStats) of the median-time run.

    ``run_solve`` returns (elapsed_ms, payload).  Returns (BenchmarkStats, median_payload)."""
    for _ in range(warmup):
        run_solve()
    times = []
    payloads = []
    for _ in range(num_runs):
        ms, payload = run_solve()
        times.append(ms)
        payloads.append(payload)
    stats = compute_stats(times)
    return stats, payloads[stats.median_run_index]


# Named warmup/measure presets (reference performance_benchmarks.hpp:70-110:
# quick(1/3), default(3/10), comprehensive(5/20), stress(2/100)).
BENCH_PRESETS = {
    "quick": {"warmup": 1, "num_runs": 3},
    "default": {"warmup": 3, "num_runs": 10},
    "comprehensive": {"warmup": 5, "num_runs": 20},
    "stress": {"warmup": 2, "num_runs": 100},
}

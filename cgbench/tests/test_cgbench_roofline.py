"""The roofline's count: the fewest bytes a point an iteration for each traffic, and the
readers that turn a traced segment into shares."""

from __future__ import annotations

import pytest

from cgbench import roofline, spec
from cgbench.harness import Run

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("traffic, itemsize, expected", [
    ("cg-const-recompute", 8, 64),   # K1 3 words + K2 5 words
    ("cg-const-recompute", 4, 32),
    ("cg-stencil5-4ranks", 8, 120),  # fused loop: K9 9 words + K4 6 words
    ("cg-csr", 8, 148),              # 5 values + 5 int32 columns + x + y, K4 6, K5 3
    ("cg-csr", 4, 84),
])
def test_bytes_per_point(traffic, itemsize, expected):
    t = spec.cell(next(w["name"] for w in spec.load_benchmark()["workloads"]
                       if w["traffic"] == traffic)).traffic
    assert roofline.bytes_per_point(t, itemsize) == expected


def test_least_time():
    t = {"roofline": {"value_words": 8, "index_bytes": 0}}
    # 20000² f64 points, one iteration: 64 B × 4e8 / 3.35e12 B/s
    assert roofline.least_s(t, 8, 20000 ** 2, 1, H100) == pytest.approx(7.641791e-3)
    assert roofline.least_s(t, 8, 20000 ** 2, 1, "some other card") is None


def _traced(compute_s, comm_s, iterations, busy_s=0.9, window_s=1.0):
    return {"compute_s": compute_s, "comm_s": comm_s, "iterations": iterations,
            "solves": 5, "busy_s": busy_s, "window_s": window_s, "ops": {}, "gaps": []}


def _run(workload, traces, points):
    cell = spec.cell(workload)
    return Run(cell=cell, kind=H100, itemsize=8, points=points, setup_s=1.0,
               operator_build_s=0.1, first_solve_s=0.2, times_ms=[1.0], total_s=0.001,
               iterations=[20], traces=traces)


def test_readers_of_a_traced_segment():
    g2 = 20000 ** 2
    run = _run("lap5-20000-f64.cg-const-recompute", [_traced(1.0, 0.0, 100)], [g2])
    least = 64 * g2 * 100 / 3350e9
    assert spec.reader("hbm_roofline_pct")(run) == pytest.approx(100 * least)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(10.0)
    band = g2 // 4
    traces = [_traced(0.5, 0.01, 200), _traced(0.6, 0.02, 200, busy_s=0.8),
              _traced(0.5, 0.01, 200), _traced(0.5, 0.01, 200)]
    run = _run("lap5-20000-f64.cg-stencil5-4ranks", traces, [band] * 4)
    slowest = 120 * band * 200 / 3350e9 / 0.6
    assert spec.reader("hbm_roofline_pct.ranks")(run) == pytest.approx(100 * slowest)
    assert spec.reader("device_idle_pct.ranks")(run) == pytest.approx(20.0)
    assert spec.reader("comm_us_per_iter.ranks")(run) == pytest.approx(100.0)
    # a card missing from the table of peaks gets no share, never 0
    run.kind = "some other card"
    assert spec.reader("hbm_roofline_pct.ranks")(run) is None

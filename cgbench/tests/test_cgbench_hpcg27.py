"""The cell hpcg27-512-f64.cg-csr27 (HPCG's 27-point problem): it resolves by name, its
roofline counts 412 bytes a point in f64 and its SpMV 340 a row, spmv_roofline_pct reads
a traced segment, the plain reference's A·x is HPCG's matrix, and the cell runs and reads
correct on the CPU at a small grid, where the program's f32 control does not."""

from __future__ import annotations

import json
import time

import pytest
import torch

from cgbench import harness, readings, roofline, single, spec
from cgbench.harness import Run

NAME = "hpcg27-512-f64.cg-csr27"
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2 ** 32 + 2 ** 31 + 27


def test_the_cell_resolves():
    cell = spec.cell(NAME)
    c = cell.config
    assert cell.chips == 1 and cell.problem_file == spec.problem_path("hpcg27")
    assert (c["nx"], c["ny"], c["nz"]) == (512, 512, 512) and c["reduced"] == []
    assert c["unknowns"] == 512 ** 3 == 134217728
    assert c["nonzeros"] == (3 * 512 - 2) ** 3 == 3609741304
    assert (c["tolerance"], c["max_iters"], c["dtype"]) == (0.0, 50, "f64")
    assert cell.traffic["mode"] == "csr" and cell.traffic["loop"] == "classic"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "solve_ms"]
    assert {m["name"] for m in cell.per_layer} == {
        "hbm_roofline_pct", "device_idle_pct", "operator_build_s", "first_solve_s",
        "spmv_roofline_pct"}
    assert not hasattr(cell.problem(), spec.SHARDED)


def test_roofline_counts():
    t = spec.cell(NAME).traffic
    assert roofline.bytes_per_point(t, 8) == 412  # 27 values + 27 columns + x + y, K4, K5
    assert roofline.bytes_per_point({"roofline": t["spmv"]}, 8) == 340
    assert roofline.bytes_per_point(spec.cell("lap5-20000-f64.cg-csr").traffic, 8) == 148


def _run(workload, ops, iterations=100, points=512 ** 3, kind=H100, traced=True):
    tr = {"compute_s": 1.0, "comm_s": 0.0, "iterations": iterations, "solves": 2,
          "busy_s": 1.0, "window_s": 1.01, "ops": ops, "gaps": []}
    return Run(cell=spec.cell(workload), kind=kind, itemsize=8, points=[points], setup_s=1.0,
               operator_build_s=0.1, first_solve_s=0.2, times_ms=[1.0], total_s=0.001,
               iterations=[50], traces=[tr] if traced else [])


def test_spmv_roofline_reads_the_kernels_device_time():
    read = spec.reader("spmv_roofline_pct")
    ops = {"void (anonymous namespace)::spmv_ell_kernel<double, true>(double const*)": 0.6,
           "void (anonymous namespace)::spmv_ell_kernel<double, false>(double const*)": 0.2,
           "void (anonymous namespace)::cg_update_kernel<double>(double*)": 0.3}
    least = 340 * 512 ** 3 * 100 / 3350e9
    assert read(_run(NAME, ops)) == pytest.approx(100 * least / 0.8)
    assert read(_run(NAME, {"cg_update_kernel": 0.3})) is None  # no such kernel traced
    assert read(_run(NAME, ops, traced=False)) is None
    assert read(_run(NAME, ops, kind="some other card")) is None
    # cell 4's traffic has no spmv entry
    assert read(_run("lap5-20000-f64.cg-csr", ops, points=20000 ** 2)) is None


def _dense(n, diag, offdiag):
    """HPCG's matrix on an n³ grid from its definition, row (iz·n + iy)·n + ix."""
    a = torch.zeros((n ** 3, n ** 3), dtype=torch.float64)
    pts = [(z, y, x) for z in range(n) for y in range(n) for x in range(n)]
    for row, (z, y, x) in enumerate(pts):
        for col, (zz, yy, xx) in enumerate(pts):
            if max(abs(z - zz), abs(y - yy), abs(x - xx)) <= 1:
                a[row, col] = diag if row == col else offdiag
    return a


def test_reference_apply_is_hpcgs_matrix():
    c = spec.cell(NAME).config
    problem = spec.problem("hpcg27")
    assert problem.shape(c) == (512, 512, 512) and problem.shape(c, 4) == (4, 4, 4)
    x = torch.randn((4, 4, 4), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    want = _dense(4, c["diag"], c["offdiag"]) @ x.reshape(-1)
    torch.testing.assert_close(problem.apply(x, c).reshape(-1), want, rtol=1e-14,
                               atol=1e-13)
    out = torch.empty_like(x)
    assert problem.apply(x, c, out=out) is out and torch.equal(out, problem.apply(x, c))


def test_the_cell_runs_on_the_cpu_and_its_control_fails():
    """At 8³ the window's CG sets take 50 iterations, as the reference's, and x reads
    within x_err's limit; the program in f32, the control, lands above it."""
    cell = spec.cell(NAME)
    record = single.run(cell, SEED, 0.2, False, time.time(), device="cpu", grid=8)
    line = harness.result(cell, record, False, record["kind"], "cpu")
    assert line["correct"], line["checks"]
    assert set(record["iterations"]) == {50} and record["ref_iterations"] == 50
    assert record["points"] == [512] and line["failed"] == 0
    (control,) = readings.collect(cell, [SEED + 1], dtype="f32", device="cpu", grid=8)
    assert control["x_err"] > cell.config["limits"]["x_err"]
    assert json.dumps(line)


def _three_short(solve):
    """A CG set stopped three iterations short of its 50 (``faults.early_stop`` loosens
    the tolerance, which a set at tolerance 0 does not have)."""
    import dataclasses

    from tpusparse_torch.solvers import cg

    one = cg.cg_solve

    def short(op, b, config, **kw):
        return one(op, b, config=dataclasses.replace(config, max_iters=config.max_iters - 3),
                   **kw)

    def broken():
        cg.cg_solve = short
        try:
            return solve()
        finally:
            cg.cg_solve = one
    return broken


def test_a_set_stopped_short_is_not_correct():
    cell = spec.cell(NAME)
    record = single.run(cell, SEED, 0.2, False, time.time(), device="cpu", grid=8,
                        wrap=_three_short)
    line = harness.result(cell, record, False, record["kind"], "cpu")
    assert not line["correct"]
    assert set(record["iterations"]) == {47}
    assert line["checks"]["iters_gap"] == {"value": 3, "limit": 0}

"""The port's CLIs against the JAX package's.

- ``cg_solver``: the same problem gives the same convergence, iteration count and solution
  checksums in the shared export schema.
- ``spmv_bench``: every mode gives the analytic Sum(y)/Norm2(y) of y = A·ones, on
  ``gen:<g>`` and on a stencil .mtx.
- ``bench.metrics``: the card's peak comes from the port's own table, never from the
  shared TPU table; the ELL and DIA byte models read the port's operands.
- the flags of both CLIs: the default mode, ``--device``, ``--host``, ``--timers``,
  ``--trace``, ``--ceiling-probe`` and the ``[SKIP]`` of a mode the matrix does not fit.
"""

import json

import numpy as np
import pytest

from tests import fixtures
from tests.test_torch_host import carry
from tpusparse import formats, io_mtx
from tpusparse.bench import metrics as jax_metrics
from tpusparse.cli import cg_solver as jax_cli
from tpusparse.cli import spmv_bench as jax_spmv
from tpusparse.generate import stencil5_spmv_checksums, write_matrix_market_stencil5
from tpusparse_torch import ops
from tpusparse_torch.bench import metrics, probes
from tpusparse_torch.cli import cg_solver, spmv_bench


def _run(main, tmp_path, name, argv):
    path = tmp_path / f"{name}.json"
    rc = main([*argv, f"--json={path}"])
    return rc, json.loads(path.read_text())


@pytest.mark.parametrize("mode,loop", [("stencil5-const", "auto"),
                                       ("stencil5-const", "classic"),
                                       ("stencil5", "auto")])
def test_cli_matches_jax_cli(tmp_path, capsys, mode, loop):
    common = ["gen:16", f"--mode={mode}", "--dtype=f64", "--runs=3", "--warmup=1",
              f"--loop={loop}"]
    rc, port = _run(cg_solver.main, tmp_path, "port", [*common, "--platform=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", common)
    assert rc == rc_j == 0
    assert port["solver"] == "tpusparse_torch-cg" and port["dtype"] == "f64"
    assert port["loop"] == ref["loop"] == (
        "recompute-ap" if mode == "stencil5-const" and loop == "auto" else "fused-classic")
    assert port["convergence"]["converged"] and ref["convergence"]["converged"]
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"]
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=1e-10)
    assert port["matrix"] == ref["matrix"]
    assert port["device"]["device_kind"] == "cpu" and port["device"]["peak_hbm_gbs"] is None
    assert port["statistics"]["total_runs"] == 3
    assert "Iterations:" in capsys.readouterr().out


def test_cli_xla_mode_csv_and_nonconvergence(tmp_path, capsys):
    csv = tmp_path / "runs.csv"
    args = ["gen:12", "--platform=cpu", "--runs=3", "--warmup=0", "--verbose=0", f"--csv={csv}"]
    assert cg_solver.main([*args, "--mode=stencil5-const-xla"]) == 0
    assert cg_solver.main([*args, "--maxiter=2"]) == 1
    lines = csv.read_text().splitlines()
    assert len(lines) == 3 and lines[0].startswith("timestamp,")
    assert "did not converge" in capsys.readouterr().err


def test_cli_refuses_what_is_not_ported(capsys):
    assert cg_solver.main(["gen:8", "--platform=cpu", "--mode=stencil5-const-xla",
                           "--loop=recompute"]) == 2
    assert cg_solver.main(["gen:8", "--platform=cpu", "--mode=stencil5",
                           "--loop=recompute"]) == 2
    assert cg_solver.main(["gen:8", "--platform=cpu", "--mode=csr", "--loop=recompute"]) == 2


def test_spmv_bench_checksums_agree(tmp_path, capsys):
    """y = A·ones through K8's twin (planes in f32 and in bf16) and K3's: the analytic
    checksums, in every mode."""
    out = tmp_path / "spmv.json"
    csv = tmp_path / "spmv.csv"
    modes = ["stencil5", "stencil5-bf16c", "stencil5-const"]
    assert spmv_bench.main(["gen:16", "--platform=cpu", f"--mode={','.join(modes)}",
                            "--runs=3", "--warmup=1", f"--json={out}", f"--csv={csv}"]) == 0
    want = stencil5_spmv_checksums(16)
    for mode in modes:
        res = json.loads((tmp_path / f"spmv_{mode}.json").read_text())
        b = res["benchmark"]
        assert b["mode"] == mode and res["dtype"] == "f32"
        assert (b["validation"]["sum_y"], b["validation"]["norm2_y"]) == pytest.approx(
            want, rel=1e-12)
        assert b["matrix"]["nnz"] == 5 * 16 * 16 - 4 * 16
        assert b["statistics"]["total_runs"] == 3
        assert b["performance"]["roofline_fraction"] is None  # the CPU has no peak
        assert res["device"]["device_kind"] == "cpu"
    bf16c = json.loads((tmp_path / "spmv_stencil5-bf16c.json").read_text())["benchmark"]
    assert bf16c["analysis"]["bytes_per_spmv"] == 16 * 16 * (5 * 2 + 2 * 4)
    assert len(csv.read_text().splitlines()) == 1 + len(modes)
    text = capsys.readouterr().out
    assert text.count("Sum(y)   = 320.0000000000000000") == len(modes)


def test_spmv_bench_resident_x_f64_and_refusals(tmp_path, capsys):
    args = ["gen:12", "--platform=cpu", "--runs=3", "--warmup=0"]
    assert spmv_bench.main([*args, "--mode=stencil5-xla,stencil5-csr", "--dtype=f64",
                            "--resident-x", f"--json={tmp_path / 'r.json'}"]) == 0
    res = json.loads((tmp_path / "r_stencil5-xla.json").read_text())
    assert res["benchmark"]["run_protocol"] == "device-resident" and res["dtype"] == "f64"
    assert res["benchmark"]["validation"]["sum_y"] == pytest.approx(
        stencil5_spmv_checksums(12)[0], rel=1e-12)
    assert spmv_bench.main([*args, "--mode=stencil5,csr-gather"]) == 2
    assert spmv_bench.main([*args, "--mode=nonsense"]) == 2
    assert "is not available" in capsys.readouterr().err
    # --ceiling-probe: the probe set runs once, before the modes, and every export carries
    # the share of its achievable GB/s and the readings
    assert spmv_bench.main([*args, "--mode=stencil5,csr", "--ceiling-probe",
                            f"--json={tmp_path / 'c.json'}"]) == 0
    assert "[INFO] ceiling probe: read " in capsys.readouterr().out
    for mode in ("stencil5", "csr"):
        res = json.loads((tmp_path / f"c_{mode}.json").read_text())
        perf = res["benchmark"]["performance"]
        assert perf["achievable_gbs"] > 0
        assert perf["roofline_fraction_achievable"] == pytest.approx(
            perf["bandwidth_gbs"] / perf["achievable_gbs"])
        probe = res["ceiling_probe"]
        assert probe["probes"] == list(probes.PROBES)
        assert probe["achievable_gbs"] == perf["achievable_gbs"]
        assert probe["probes_over_peak"] == [] and probe["peak_gbs"] is None


def test_metrics_take_the_cards_peak_not_the_tpus():
    """The shared table answers an H100 with a v5e's 819 GB/s; the port's does not."""
    op = ops.get_operator("stencil5", carry(formats.Stencil5(64, None, (5.0, -1.0))),
                          device="cpu")
    nbytes = 7 * 64 * 64 * 4
    assert jax_metrics.chip_peaks("NVIDIA H100 80GB HBM3")[0] == 819.0  # the trap
    m = metrics.calculate_spmv_metrics(op, nbytes / 2.0e12 * 1e3, dtype_itemsize=4,
                                       device_kind="NVIDIA H100 80GB HBM3",
                                       l2_bytes=50 * 2**20)
    assert m.bandwidth_gbs == pytest.approx(2000.0)
    assert m.roofline_fraction == pytest.approx(2000.0 / 3350.0)
    assert m.bound == "memory-bound" and m.bytes_moved == nbytes
    assert any(f.startswith("working_set_below_l2") for f in m.timing_flags)
    assert not any("exceeds" in f for f in m.timing_flags)
    unknown = metrics.calculate_spmv_metrics(op, 1.0, dtype_itemsize=4, device_kind="Some GPU")
    assert unknown.roofline_fraction is None and unknown.bound.startswith("unknown")
    assert unknown.timing_flags == ()
    fast = metrics.calculate_spmv_metrics(op, 1e-5, dtype_itemsize=4,
                                          device_kind="NVIDIA H100 80GB HBM3")
    assert any("exceeds_nominal_peak" in f for f in fast.timing_flags)
    xla = metrics.calculate_spmv_metrics(op, 1.0, dtype_itemsize=8, device_kind="cpu",
                                         mode="stencil5-const-xla")
    assert xla.bytes_moved == 2 * 64 * 64 * 8


@pytest.mark.parametrize("mode,jmode", [("csr", "csr-xla"), ("dia", "dia"), ("bcoo", "bcoo")])
def test_cli_generic_modes_match_jax_cli(tmp_path, capsys, mode, jmode):
    """The generic modes through the CG CLI against the JAX CLI (its csr-xla for csr: the
    XLA gather the port's twin ports, without the JAX csr kernel's interpret-mode cost).
    The RMS-vs-ones heuristic is printed for the stencil modes only."""
    common = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=1"]
    rc, port = _run(cg_solver.main, tmp_path, "port", [*common, f"--mode={mode}",
                                                      "--platform=cpu"])
    out = capsys.readouterr().out
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", [*common, f"--mode={jmode}"])
    assert rc == rc_j == 0 and port["loop"] == "fused-classic"
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"] == 16
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=1e-10)
    assert port["matrix"] == ref["matrix"]
    assert "Iterations:" in out and "RMS error" not in out


def test_spmv_bench_generic_modes_on_mtx(tmp_path, capsys):
    """csr, dia and bcoo on a stencil .mtx: the analytic checksums, and the port's byte
    models (the shared csr/dia models read the JAX operator's _buffers, which the port's
    operator does not have: AttributeError)."""
    g = 12
    mtx = tmp_path / "g12.mtx"
    write_matrix_market_stencil5(str(mtx), g)
    modes = ["csr", "dia", "bcoo", "csr-xla", "dia-xla"]
    out = tmp_path / "spmv.json"
    assert spmv_bench.main([str(mtx), "--platform=cpu", f"--mode={','.join(modes)}",
                            "--runs=3", "--warmup=1", f"--json={out}"]) == 0
    n, nnz = g * g, 5 * g * g - 4 * g
    want_bytes = {"csr": n * 5 * (4 + 4) + 2 * n * 4, "dia": (5 + 2) * n * 4,
                  "bcoo": nnz * (4 + 4) + (n + 1) * 4 + 2 * n * 4}
    want = stencil5_spmv_checksums(g)
    for mode in modes:
        b = json.loads((tmp_path / f"spmv_{mode}.json").read_text())["benchmark"]
        assert b["matrix"] == {"name": "g12.mtx", "rows": n, "cols": n, "nnz": nnz,
                               "grid_size": g}
        assert (b["validation"]["sum_y"], b["validation"]["norm2_y"]) == pytest.approx(
            want, rel=1e-12)
        assert b["analysis"]["bytes_per_spmv"] == want_bytes[mode.removesuffix("-xla")]
    assert capsys.readouterr().out.count("Sum(y)   = 192.0000000000000000") == len(modes)


# the same argv to both CLIs (the port's also names the CPU): the default mode, the
# device-native flag, the host-stepped runs
SAME_ARGV = {
    "default mode": ["gen:16", "--dtype=f64", "--runs=3", "--warmup=1"],
    "--device": ["gen:12", "--dtype=f64", "--device", "--runs=3", "--warmup=1"],
    "--host": ["gen:12", "--dtype=f64", "--host"],
    "--timers": ["gen:12", "--dtype=f64", "--timers", "--runs=3", "--warmup=0"],
    "--timers --loop=recompute": ["gen:12", "--dtype=f64", "--mode=stencil5-const",
                                  "--loop=recompute", "--timers", "--runs=3", "--warmup=0"],
}


@pytest.mark.parametrize("case", list(SAME_ARGV))
def test_cli_flags_match_jax_cli(tmp_path, capsys, case):
    """mode ``stencil5`` by default; ``--device`` is the device-native loop; ``--host``
    and ``--timers`` run the host-stepped loop, export ``loop`` = ``host-stepped`` (also
    under ``--loop=recompute``: the stepped loop is the classic one) and print the phase
    split; ``--host`` times one run.  Same exit code, mode, loop and iterations as the
    JAX CLI, Sum/Norm2 to 1e-10."""
    argv = SAME_ARGV[case]
    rc, port = _run(cg_solver.main, tmp_path, "port", [*argv, "--platform=cpu"])
    out = capsys.readouterr().out
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    stepped = case.startswith(("--host", "--timers"))
    assert port["mode"] == ref["mode"] == ("stencil5-const" if "recompute" in case
                                           else "stencil5")
    assert port["loop"] == ref["loop"] == ("host-stepped" if stepped else "fused-classic")
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"]
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=1e-10)
    runs = 1 if case == "--host" else 3
    assert port["statistics"]["total_runs"] == ref["statistics"]["total_runs"] == runs
    t = port["timing"]
    if stepped:
        assert t["spmv_ms"] > 0 and t["blas1_ms"] > 0 and t["reductions_ms"] > 0
        assert "spmv_kernel_ms_per_apply" not in t
        assert port["performance"]["gflops_spmv"] == pytest.approx(
            2 * port["matrix"]["nnz"] * port["convergence"]["iterations"]
            / (t["spmv_ms"] / 1e3) / 1e9)
        assert "  SpMV:" in out and "  BLAS1:" in out
    else:
        assert t["spmv_ms"] == 0.0 and t["spmv_kernel_ms_per_apply"] > 0
        assert "  SpMV:" not in out


def test_cli_host_and_device_exclude_each_other(capsys):
    """rc 2 in both CLIs, before the operand is loaded (the .mtx does not exist)."""
    argv = ["missing.mtx", "--host", "--device"]
    assert cg_solver.main([*argv, "--platform=cpu"]) == jax_cli.main(argv) == 2
    assert capsys.readouterr().err.count("mutually exclusive") == 2


def test_cli_trace_holds_the_phase_names(tmp_path, capsys):
    """--trace profiles one more solve into a Chrome trace JSON holding the phase scopes;
    the statistics and the export are those of the runs without it (the JAX CLI's
    export, traced too, agrees)."""
    logdir = tmp_path / "trace"
    argv = ["gen:12", "--dtype=f64", "--runs=3", "--warmup=0"]
    rc, port = _run(cg_solver.main, tmp_path, "port",
                    [*argv, "--platform=cpu", f"--trace={logdir}"])
    assert f"trace captured: {logdir}" in capsys.readouterr().out
    (trace,) = logdir.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"SpMV", "BLAS_AXPY", "BLAS_Update_P"} <= names
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", [*argv, f"--trace={tmp_path / 'jt'}"])
    assert rc == rc_j == 0 and port["statistics"]["total_runs"] == 3
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"]
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=1e-10)


def test_spmv_bench_skips_a_mode_the_matrix_does_not_fit(tmp_path, capsys):
    """A square .mtx that is no 5-point stencil (the 9-point stencil at g = 12): mode
    stencil5 raises ValueError in its operator's build, so both CLIs print [SKIP], run csr
    and return 1, with the same checksums."""
    mtx = tmp_path / "nine.mtx"
    csr = fixtures.ninepoint(12)
    rows = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_ptr))
    io_mtx.write_matrix_market(str(mtx), formats.COOMatrix(csr.num_rows, csr.num_cols, rows,
                                                           csr.col_idx, csr.val))
    argv = [str(mtx), "--mode=stencil5,csr", "--runs=3", "--warmup=0", "--dtype=f64"]
    rc = spmv_bench.main([*argv, "--platform=cpu", f"--json={tmp_path / 'port.json'}"])
    err = capsys.readouterr().err
    rc_j = jax_spmv.main([*argv, f"--json={tmp_path / 'jax.json'}"])
    assert rc == rc_j == 1
    assert "[SKIP] mode stencil5:" in err and "[SKIP] mode stencil5:" in capsys.readouterr().err
    assert not (tmp_path / "port_stencil5.json").exists()
    got = json.loads((tmp_path / "port_csr.json").read_text())["benchmark"]["validation"]
    want = json.loads((tmp_path / "jax_csr.json").read_text())["benchmark"]["validation"]
    assert got["sum_y"] == pytest.approx(fixtures.ninepoint_checksum(12), rel=1e-12)
    assert got == pytest.approx(want, rel=1e-12)

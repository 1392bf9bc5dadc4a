"""The port's CLIs against the JAX package's.

- ``cg_solver``: the same problem gives the same convergence, iteration count and solution
  checksums in the shared export schema.
- ``spmv_bench``: every mode gives the analytic Sum(y)/Norm2(y) of y = A·ones, on
  ``gen:<g>`` and on a stencil .mtx.
- ``bench.metrics``: the card's peak comes from the port's own table, never from the
  shared TPU table; the ELL and DIA byte models read the port's operands.
"""

import json

import numpy as np
import pytest

from tpusparse import formats
from tpusparse.bench import metrics as jax_metrics
from tpusparse.cli import cg_solver as jax_cli
from tpusparse.generate import stencil5_spmv_checksums, write_matrix_market_stencil5
from tpusparse_torch import ops
from tpusparse_torch.bench import metrics
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
    rc, port = _run(cg_solver.main, tmp_path, "port", [*common, "--device=cpu"])
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
    args = ["gen:12", "--device=cpu", "--runs=3", "--warmup=0", "--verbose=0", f"--csv={csv}"]
    assert cg_solver.main([*args, "--mode=stencil5-const-xla"]) == 0
    assert cg_solver.main([*args, "--maxiter=2"]) == 1
    lines = csv.read_text().splitlines()
    assert len(lines) == 3 and lines[0].startswith("timestamp,")
    assert "did not converge" in capsys.readouterr().err


def test_cli_refuses_what_is_not_ported(capsys):
    assert cg_solver.main(["gen:8", "--device=cpu", "--mode=stencil5-const-xla",
                           "--loop=recompute"]) == 2
    assert cg_solver.main(["gen:8", "--device=cpu", "--mode=stencil5",
                           "--loop=recompute"]) == 2
    assert cg_solver.main(["gen:8", "--device=cpu", "--mode=csr", "--loop=recompute"]) == 2


def test_spmv_bench_checksums_agree(tmp_path, capsys):
    """y = A·ones through K8's twin (planes in f32 and in bf16) and K3's: the analytic
    checksums, in every mode."""
    out = tmp_path / "spmv.json"
    csv = tmp_path / "spmv.csv"
    modes = ["stencil5", "stencil5-bf16c", "stencil5-const"]
    assert spmv_bench.main(["gen:16", "--device=cpu", f"--mode={','.join(modes)}",
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
    args = ["gen:12", "--device=cpu", "--runs=3", "--warmup=0"]
    assert spmv_bench.main([*args, "--mode=stencil5-xla,stencil5-csr", "--dtype=f64",
                            "--resident-x", f"--json={tmp_path / 'r.json'}"]) == 0
    res = json.loads((tmp_path / "r_stencil5-xla.json").read_text())
    assert res["benchmark"]["run_protocol"] == "device-resident" and res["dtype"] == "f64"
    assert res["benchmark"]["validation"]["sum_y"] == pytest.approx(
        stencil5_spmv_checksums(12)[0], rel=1e-12)
    assert spmv_bench.main([*args, "--mode=stencil5,csr-gather"]) == 2
    assert spmv_bench.main([*args, "--mode=nonsense"]) == 2
    assert "is not available" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        spmv_bench.main([*args, "--ceiling-probe"])


def test_metrics_take_the_cards_peak_not_the_tpus():
    """The shared table answers an H100 with a v5e's 819 GB/s; the port's does not."""
    op = ops.get_operator("stencil5", formats.Stencil5(64, None, (5.0, -1.0)), device="cpu")
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
                                                      "--device=cpu"])
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
    assert spmv_bench.main([str(mtx), "--device=cpu", f"--mode={','.join(modes)}",
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

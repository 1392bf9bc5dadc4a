"""The port's CG CLI (tpusparse_torch.cli.cg_solver) against the JAX package's CLI: the
same problem gives the same convergence, iteration count and solution checksums in the
shared export schema."""

import json

import numpy as np
import pytest

from tpusparse.cli import cg_solver as jax_cli
from tpusparse_torch.cli import cg_solver


def _run(main, tmp_path, name, argv):
    path = tmp_path / f"{name}.json"
    rc = main([*argv, f"--json={path}"])
    return rc, json.loads(path.read_text())


@pytest.mark.parametrize("loop", ["auto", "classic"])
def test_cli_matches_jax_cli(tmp_path, capsys, loop):
    common = ["gen:16", "--mode=stencil5-const", "--dtype=f64", "--runs=3", "--warmup=1",
              f"--loop={loop}"]
    rc, port = _run(cg_solver.main, tmp_path, "port", [*common, "--device=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", common)
    assert rc == rc_j == 0
    assert port["solver"] == "tpusparse_torch-cg" and port["dtype"] == "f64"
    assert port["loop"] == ref["loop"] == ("fused-classic" if loop == "classic"
                                           else "recompute-ap")
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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        cg_solver.main(["gen:8", "--device=cpu", "--mode=stencil5"])

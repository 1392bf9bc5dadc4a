"""The port's multichip CLI (tpusparse_torch.cli.cg_solver_multichip) against the JAX
package's (tpusparse/cli/cg_solver_multichip.py).

- the flags: the JAX CLI's, none missing, and ``--platform``;
- ``gen:16`` on 1, 2 and 4 chips (the port's ranks: gloo processes on the CPU; the JAX
  CLI's: virtual CPU devices): the same mode, iterations and Sum/Norm2 (1e-10) in the
  shared export schema, the port's export also saying which loop ran and on how many
  ranks, with the gather's time and, on several ranks, their measured times;
- a stencil .mtx read by every rank, and a padded ``stencil5-const`` request recorded as
  the ``stencil5`` that ran, both as in JAX;
- the refusals, each rc 2: a non-stencil .mtx without ``--mode=csr`` (as in JAX),
  ``--mesh2d`` (not ported) and ``--dtype=bf16`` (no bf16 state);
- ``--timers`` on 2 ranks: the host-stepped loop with its halo and allreduce buckets.
"""

import json

import numpy as np
import pytest

from tpusparse_torch.cli import cg_solver_multichip as port_cli


def _run(main, tmp_path, name, argv):
    path = tmp_path / f"{name}.json"
    rc = main([*argv, f"--json={path}"])
    return rc, (json.loads(path.read_text()) if path.exists() else None)


def _same_solution(port, ref):
    assert port["convergence"]["converged"] and ref["convergence"]["converged"]
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"]
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=1e-10)


def test_flags_match_the_jax_cli():
    from tpusparse.cli import cg_solver_multichip as jax_cli

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings} | {
            a.dest for a in parser._actions if not a.option_strings}

    assert flags(port_cli.build_parser()) == flags(jax_cli.build_parser()) | {"--platform"}
    choices = {a.dest: a.choices for a in port_cli.build_parser()._actions}
    jchoices = {a.dest: a.choices for a in jax_cli.build_parser()._actions}
    assert choices["mode"] == jchoices["mode"] and choices["dtype"] == jchoices["dtype"]


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_cli_matches_jax_cli(tmp_path, capfd, chips):
    from tpusparse.cli import cg_solver_multichip as jax_cli

    argv = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=1", f"--chips={chips}"]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu"])
    out = capfd.readouterr().out
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["mode"] == ref["mode"] == "stencil5"
    _same_solution(port, ref)
    assert port["matrix"] == ref["matrix"]
    assert port["solver"] == f"tpusparse-cg-sharded-{chips}chip"
    assert port["loop"] == "classic" and port["dtype"] == "f64"
    assert port["statistics"]["total_runs"] == ref["statistics"]["total_runs"] == 3
    t = port["timing"]
    assert t["num_chips"] == chips and t["allgather_ms"] > 0
    assert ("solve_time_max_ms" in t) == (chips > 1)
    if chips > 1:
        assert len(t["per_process_ms"]) == chips and t["load_imbalance_pct"] >= 0
    assert out.count("Iterations:") == 1  # rank 0 alone reports
    assert f"[INFO] ranks: {chips} x cpu" in out


def test_cli_reads_an_mtx_on_every_rank(tmp_path):
    from tpusparse.cli import cg_solver_multichip as jax_cli
    from tpusparse.generate import write_matrix_market_stencil5

    mtx = tmp_path / "g12.mtx"
    write_matrix_market_stencil5(str(mtx), 12)
    argv = [str(mtx), "--dtype=f64", "--runs=3", "--warmup=0", "--chips=2"]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["matrix"] == ref["matrix"] and port["matrix"]["name"] == "g12.mtx"
    _same_solution(port, ref)


def test_cli_padded_const_runs_as_stencil5(tmp_path):
    from tpusparse.cli import cg_solver_multichip as jax_cli

    argv = ["gen:30", "--mode=stencil5-const", "--dtype=f64", "--runs=3", "--warmup=0",
            "--chips=4"]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["mode"] == ref["mode"] == "stencil5" and port["loop"] == "classic"
    _same_solution(port, ref)


def test_cli_refuses_a_non_stencil_mtx(tmp_path, capfd):
    """A permutation matrix through a stencil mode: rc 2 and the pointer to --mode=csr,
    from rank 0 of two, as from the JAX CLI."""
    from tpusparse import io_mtx
    from tpusparse.cli import cg_solver_multichip as jax_cli
    from tpusparse.formats import COOMatrix

    n = 16
    rows = np.arange(n, dtype=np.int64)
    coo = COOMatrix(n, n, rows, rows[::-1].copy(), np.random.RandomState(0).rand(n) + 1)
    mtx = tmp_path / "perm.mtx"
    io_mtx.write_matrix_market(str(mtx), coo)
    argv = [str(mtx), "--runs=1", "--warmup=0"]
    assert port_cli.main([*argv, "--platform=cpu", "--chips=2"]) == 2
    assert capfd.readouterr().err.count("--mode=csr") == 1
    assert jax_cli.main(argv) == 2
    assert "--mode=csr" in capfd.readouterr().err


def test_cli_refuses_what_is_not_ported(capsys):
    assert port_cli.main(["gen:16", "--platform=cpu", "--mesh2d=2x2"]) == 2
    assert "2-D decomposition is not ported yet (ROADMAP Queue 1 item 7)" in \
        capsys.readouterr().err
    assert port_cli.main(["gen:16", "--platform=cpu", "--dtype=bf16"]) == 2
    assert "--dtype=bf16" in capsys.readouterr().err


def test_cli_timers_on_two_ranks(tmp_path):
    from tpusparse.cli import cg_solver_multichip as jax_cli

    argv = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=0", "--chips=2", "--timers"]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["loop"] == "host-stepped"
    _same_solution(port, ref)
    t = port["timing"]
    assert min(t["halo_ms"], t["allreduce_ms"], t["spmv_ms"], t["blas1_ms"]) > 0
    assert t["reductions_ms"] == t["allreduce_ms"]
    assert port["performance"]["gflops_spmv"] > 0

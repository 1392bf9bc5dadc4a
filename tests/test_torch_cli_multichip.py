"""The port's multichip CLI (tpusparse_torch.cli.cg_solver_multichip) against the JAX
package's (tpusparse/cli/cg_solver_multichip.py).

- the flags: the JAX CLI's, none missing, and ``--platform``;
- ``gen:16`` on 1, 2 and 4 chips (the port's: a mesh of CPU shards in one process; the
  JAX CLI's: virtual CPU devices): the same mode, iterations and Sum/Norm2 (1e-10) in the
  shared export schema, the port's export also saying which loop ran, on how many
  shards, the assembly's time and the mesh's topology (one process);
- the same run in a group of gloo ranks (as under torchrun) takes the gloo path: one
  process a rank, their measured times, and the mesh's Sum/Norm2 bit for bit;
- a stencil .mtx read by every rank, and a padded ``stencil5-const`` request recorded as
  the ``stencil5`` that ran, both as in JAX;
- the refusals, each rc 2: a non-stencil .mtx without ``--mode=csr`` (as in JAX),
  ``--mode=csr`` with ``--mesh2d`` (as in JAX), a malformed ``--mesh2d`` and
  ``--dtype=bf16`` (no bf16 state);
- ``--timers`` on 2 ranks: the host-stepped loop with its halo and allreduce buckets;
- ``--mesh2d=2x2`` (four shards, blocks of the 2-D decomposition) against the JAX CLI's
  ``--mesh2d=2x2``: the same mode, iterations and Sum/Norm2 (1e-10), solver
  ``tpusparse-cg-sharded2d-2x2``, and with ``--timers`` its four buckets.
"""

import json

import numpy as np
import pytest

from tpusparse_torch import dist
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
    assert "solve_time_max_ms" not in t  # one process: no ranks to time
    topo = port["topology"]
    assert topo["transport"] == "mesh" and topo["axes"] == {"x": chips}
    assert topo["num_devices"] == chips and topo["num_processes"] == 1
    assert topo["process_of_device"] == [0] * chips and topo["device_kinds"] == ["cpu"]
    assert out.count("Iterations:") == 1
    assert f"[INFO] mesh: {chips} x cpu (1 process(es))" in out


def _cli_json_in_group(device, argv, path):
    rc = port_cli.main([*argv, f"--json={path}"])
    return rc, (json.loads(path.read_text()) if dist.rank() == 0 else None)


@pytest.mark.parametrize("chips", [2, 4])
def test_cli_in_a_group_takes_the_gloo_path(tmp_path, capfd, chips):
    """Every process of a gloo group runs the CLI, as under torchrun: one rank a process,
    rank 0 reporting, the ranks' measured times, and Sum/Norm2 bit for bit the mesh's."""
    argv = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=0", "--platform=cpu",
            f"--chips={chips}"]
    rc, gloo = dist.launch_local(_cli_json_in_group, chips, argv, tmp_path / "gloo.json",
                                 device="cpu")
    out = capfd.readouterr().out
    rc_m, mesh = _run(port_cli.main, tmp_path, "mesh", argv)
    assert rc == rc_m == 0
    assert gloo["topology"]["transport"] == "gloo"
    assert gloo["topology"]["num_processes"] == chips
    assert len(gloo["timing"]["per_process_ms"]) == chips
    assert gloo["timing"]["load_imbalance_pct"] >= 0
    assert f"[INFO] ranks: {chips} x cpu ({chips} process(es), gloo)" in out
    assert out.count("Iterations:") == 1  # rank 0 alone reports
    assert gloo["convergence"] == mesh["convergence"]
    assert gloo["validation"] == mesh["validation"]


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
    """``--mode=csr`` on a 2-D mesh, which the JAX CLI refuses too, and ``stencil5-const``
    on row bands at ``--dtype=bf16``, whose recompute loop refuses a bf16 state (the JAX
    CLI fails there)."""
    assert port_cli.main(["gen:16", "--platform=cpu", "--mode=csr", "--mesh2d=2x2"]) == 2
    assert "the generic csr mode is 1-D row-band only" in capsys.readouterr().err
    assert port_cli.main(["gen:16", "--platform=cpu", "--dtype=bf16",
                          "--mode=stencil5-const"]) == 2
    assert "--dtype=bf16" in capsys.readouterr().err


@pytest.mark.parametrize("mesh", ["2by2", "2x", "0x4", "2x2x2"])
def test_cli_refuses_a_malformed_mesh2d(capsys, mesh):
    from tpusparse.cli import cg_solver_multichip as jax_cli

    assert port_cli.main(["gen:16", "--platform=cpu", f"--mesh2d={mesh}"]) == 2
    assert "--mesh2d expects RxC" in capsys.readouterr().err
    if mesh != "0x4":  # the JAX CLI takes 0 and fails later, in jax.make_mesh
        assert jax_cli.main(["gen:16", f"--mesh2d={mesh}"]) == 2


def test_cli_mesh2d_refuses_a_grid_that_does_not_divide(capfd):
    """A mesh of four shards returns 2 and says why once."""
    assert port_cli.main(["gen:18", "--platform=cpu", "--mesh2d=1x4", "--runs=1",
                          "--warmup=0"]) == 2
    assert capfd.readouterr().err.count("must divide the mesh extents (1, 4)") == 1


def _cli_in_group(device, argv):
    return port_cli.main(argv)


def test_cli_mesh2d_in_a_group_of_another_size(capfd):
    """In a group (as under torchrun) the group's size must divide R·C: R·C blocks, one
    or several a rank (tests/test_torch_multihost_2d.py runs 2 ranks on 2x4)."""
    argv = ["gen:16", "--platform=cpu", "--mesh2d=2x2", "--runs=1", "--warmup=0"]
    assert dist.launch_local(_cli_in_group, 3, argv, device="cpu") == 2
    assert "--mesh2d=2x2 has 4 blocks, not a multiple of the group's 3 ranks" in \
        capfd.readouterr().err


def test_cli_mesh2d_reads_an_mtx(tmp_path):
    """A stencil .mtx through the 2-D blocks: each rank slices its block of the file's
    planes."""
    from tpusparse.cli import cg_solver_multichip as jax_cli
    from tpusparse.generate import write_matrix_market_stencil5

    mtx = tmp_path / "g12.mtx"
    write_matrix_market_stencil5(str(mtx), 12)
    argv = [str(mtx), "--mesh2d=2x2", "--dtype=f64", "--runs=3", "--warmup=0"]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu"])
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["matrix"] == ref["matrix"] and port["matrix"]["name"] == "g12.mtx"
    _same_solution(port, ref)


@pytest.mark.parametrize("timers", [False, True])
def test_cli_mesh2d_matches_jax_cli(tmp_path, capfd, timers):
    from tpusparse.cli import cg_solver_multichip as jax_cli

    argv = ["gen:16", "--mesh2d=2x2", "--dtype=f64", "--runs=3", "--warmup=1",
            *(["--timers"] if timers else [])]
    rc, port = _run(port_cli.main, tmp_path, "port", [*argv, "--platform=cpu", "--chips=3"])
    out = capfd.readouterr().out
    rc_j, ref = _run(jax_cli.main, tmp_path, "jax", argv)
    assert rc == rc_j == 0
    assert port["mode"] == ref["mode"] == "stencil5"
    assert port["solver"] == ref["solver"] == "tpusparse-cg-sharded2d-2x2"
    _same_solution(port, ref)
    assert port["loop"] == ("host-stepped" if timers else "classic")
    t = port["timing"]
    assert t["num_chips"] == 4 and t["allgather_ms"] > 0  # --chips is ignored, as in JAX
    assert port["topology"]["axes"] == {"x": 2, "y": 2}
    assert port["topology"]["num_processes"] == 1
    assert "[INFO] mesh: 4 x cpu (1 process(es))" in out and out.count("Iterations:") == 1
    if timers:
        assert min(t["halo_ms"], t["allreduce_ms"], t["spmv_ms"], t["blas1_ms"]) > 0


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

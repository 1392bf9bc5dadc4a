"""2-D blocks, several a rank (``dist.make_rank_mesh((R, C))``): the port's counterpart of
the JAX CLI's ``--multihost --mesh2d``, where one global (R, C) mesh spans the processes'
devices and each process holds several blocks.

Here gloo ranks (``dist.launch_local``) each drive R·C / W CPU blocks of one mesh: halos
copied between a rank's own blocks, the rows and columns whose neighbour lives on another
rank passed by the rank link (several messages between the same two ranks in one
exchange, told apart by tag), every dot's partials gathered and added in global shard
order.  One group of 2 ranks runs every 2-rank case of the file, one group of 4 ranks
the 4-rank cases (the ``ranks`` fixture); the tests read their results.  Bars:

- 2 ranks × 4 blocks of (2, 4) (rows cross the ranks), (4, 2) (two blocks' rows between
  the same two ranks) and (1, 8) (a column crosses), at g = 16 and 24; 4 ranks × 2 blocks
  of (2, 4) (rows to rank r ± 2, columns to r ± 1); the stepped loop on (2, 4); the
  constant stencil on (2, 4); ``stencil5-bf16c`` f32 on (2, 4): x gathered to rank 0 bit
  for bit the one-process mesh of the same shape (``dist.make_mesh((R, C),
  devices="cpu")``), in as many iterations, and (f64) within 1e-12 of the JAX package's
  ``cg_solve_sharded_2d`` on the conftest's 8 devices with equal iterations;
- ``dist.describe_mesh``: the JAX keys and axes, each block's process as JAX numbers them
  (process by process, row-major), the rank's blocks;
- each rank's ``HALO_CALLS``: a row exchange an iteration for each of its blocks with a
  N/S neighbour, a column exchange for each with a W/E neighbour, a side-column
  correction for each such neighbour, and all ranks' counts summed equal to the
  one-process mesh's;
- the multichip CLI with ``--mesh2d=2x4`` on 2 ranks: Sum/Norm2 and iterations bit for bit
  the one-process CLI's, its topology 2 processes over 8 shards, the gloo transport;
  ``--mesh2d=2x3`` on 4 ranks returns 2.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests.
"""

import json

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.cli import cg_solver_multichip as port_cli
from tpusparse_torch.solvers import cg_sharded

F64, F32 = torch.float64, torch.float32
# name -> (ranks, mesh shape, grid, loop, solver arguments)
CASES = {
    "2x4 g16": (2, (2, 4), 16, "solve", dict(mode="stencil5", dtype=F64)),
    "2x4 g24": (2, (2, 4), 24, "solve", dict(mode="stencil5", dtype=F64)),
    "4x2 g16": (2, (4, 2), 16, "solve", dict(mode="stencil5", dtype=F64)),
    "4x2 g24": (2, (4, 2), 24, "solve", dict(mode="stencil5", dtype=F64)),
    "1x8 g16": (2, (1, 8), 16, "solve", dict(mode="stencil5", dtype=F64)),
    "1x8 g24": (2, (1, 8), 24, "solve", dict(mode="stencil5", dtype=F64)),
    "stepped 2x4 g16": (2, (2, 4), 16, "stepped", dict(mode="stencil5", dtype=F64)),
    "const 2x4 g24": (2, (2, 4), 24, "solve", dict(mode="stencil5-const", dtype=F64)),
    "bf16c f32 2x4 g16": (2, (2, 4), 16, "solve", dict(mode="stencil5-bf16c", dtype=F32)),
    "4 ranks 2x4 g16": (4, (2, 4), 16, "solve", dict(mode="stencil5", dtype=F64)),
    "4 ranks 2x4 g24": (4, (2, 4), 24, "solve", dict(mode="stencil5", dtype=F64)),
}
SOLVERS = {"solve": cg_sharded.cg_solve_sharded_2d,
           "stepped": cg_sharded.cg_solve_sharded_2d_stepped}
RANKS = (2, 4)


def _rank(device, cases):
    """Every case of ``cases`` on this rank's blocks; rank 0 returns {case: (x gathered,
    iterations, every rank's HALO_CALLS, describe_mesh, every rank's local shards)}."""
    del device
    out = {}
    for name, (_w, shape, g, loop, kw) in cases.items():
        mesh = dist.make_rank_mesh(shape, devices="cpu")
        cg_sharded.reset_halo_calls()
        x, s = SOLVERS[loop](mesh, g, **kw)
        halo = dist._all_objects(dict(cg_sharded.HALO_CALLS))
        out[name] = (dist.gather_blocks_to_host(x, shape), s.iterations, halo,
                     dist.describe_mesh(mesh), dist._all_objects(list(mesh.local)))
        cg_sharded.clear_caches()
    return out if dist.rank() == 0 else None


@pytest.fixture(scope="module")
def ranks():
    out = {}
    for w in RANKS:
        out.update(dist.launch_local(
            _rank, w, {n: c for n, c in CASES.items() if c[0] == w}, device="cpu"))
    return out


def _one_process(shape, g, loop, kw):
    cg_sharded.reset_halo_calls()
    x, s = SOLVERS[loop](dist.make_mesh(shape, devices="cpu"), g, **kw)
    halo = dict(cg_sharded.HALO_CALLS)
    cg_sharded.clear_caches()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy(), s.iterations, halo


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_equal_one_process_mesh(ranks, name):
    _w, shape, g, loop, kw = CASES[name]
    x, k = ranks[name][:2]
    want, k_want, _ = _one_process(shape, g, loop, kw)
    assert k == k_want and x.shape == want.shape == (g, g)
    np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]["dtype"] == F64])
def test_rank_blocks_match_jax(ranks, name):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    _w, shape, g, loop, kw = CASES[name]
    x, k = ranks[name][:2]
    mesh = jax.make_mesh(shape, ("x", "y"), devices=jax.devices()[:shape[0] * shape[1]])
    solve = jcs.cg_solve_sharded_2d if loop == "solve" else jcs.cg_solve_sharded_2d_stepped
    xj, sj = solve(mesh, g, mode=kw["mode"], dtype=jnp.float64)
    assert sj.converged and k == sj.iterations
    np.testing.assert_allclose(x, np.asarray(xj, np.float64), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["2x4 g16", "4x2 g16", "1x8 g16", "4 ranks 2x4 g16"])
def test_describe_mesh_numbers_blocks_as_jax(ranks, name):
    """JAX numbers the global devices process by process and lays the (R, C) mesh over
    them row-major, so W processes × L devices give block i·C + j to process
    (i·C + j) // L; the rank mesh places its blocks the same way."""
    import jax

    from tpusparse import dist as jdist

    w, shape, *_ = CASES[name]
    d, local = ranks[name][3], ranks[name][4]
    n = shape[0] * shape[1]
    jmesh = jax.make_mesh(shape, ("x", "y"), devices=jax.devices()[:n])
    want = jdist.describe_mesh(jmesh)
    assert set(d) - {"devices"} == set(want)
    assert d["axes"] == want["axes"] == {"x": shape[0], "y": shape[1]}
    assert d["num_processes"] == w and d["num_devices"] == n
    assert d["process_of_device"] == [i // (n // w) for i in range(n)]
    assert local == [list(range(r * n // w, (r + 1) * n // w)) for r in range(w)]


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3] == "solve"])
def test_rank_blocks_halo_counters(ranks, name):
    """Each rank counts its own blocks' exchanges and corrections, one an iteration a
    block (and a W/E neighbour), as the one-process mesh counts all of them."""
    w, (nr, nc), g, loop, kw = CASES[name]
    _x, k, halo, _d, local = ranks[name]
    for r, counts in enumerate(halo):
        ij = [divmod(i, nc) for i in local[r]]
        rows = sum((i > 0) or (i < nr - 1) for i, _ in ij)
        cols = sum((j > 0) or (j < nc - 1) for _, j in ij)
        sides = sum((j > 0) + (j < nc - 1) for _, j in ij)
        assert counts["exchange"] == k * rows, (r, counts)
        assert counts["column_exchange"] == k * cols, (r, counts)
        assert counts["column_correction"] == k * sides, (r, counts)
    _, _, want = _one_process((nr, nc), g, loop, kw)
    assert {n: sum(c[n] for c in halo) for n in want} == want


# --------------------------------------------------------------------------- the CLI


def _cli_json_in_group(device, argv, path):
    rc = port_cli.main([*argv, f"--json={path}"])
    return rc, (json.loads(path.read_text()) if dist.rank() == 0 else None)


def _cli_in_group(device, argv):
    return port_cli.main(argv)


def test_cli_mesh2d_across_ranks(tmp_path, capfd):
    """``--mesh2d=2x4`` on 2 ranks: each rank drives 4 blocks; rank 0 reports Sum/Norm2
    and iterations bit for bit the one-process 2x4 CLI's, 8 shards over 2 processes, the
    gloo transport."""
    argv = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=0", "--platform=cpu",
            "--mesh2d=2x4"]
    rc, ranks_ = dist.launch_local(_cli_json_in_group, 2, argv, tmp_path / "ranks.json",
                                   device="cpu")
    out = capfd.readouterr().out
    rc_m = port_cli.main([*argv, f"--json={tmp_path / 'mesh.json'}"])
    mesh = json.loads((tmp_path / "mesh.json").read_text())
    assert rc == rc_m == 0
    assert ranks_["validation"] == mesh["validation"]
    assert ranks_["convergence"] == mesh["convergence"]
    assert ranks_["solver"] == mesh["solver"] == "tpusparse-cg-sharded2d-2x4"
    topo = ranks_["topology"]
    assert topo["transport"] == "gloo" and topo["num_devices"] == 8
    assert topo["num_processes"] == 2 and topo["process_of_device"] == [0] * 4 + [1] * 4
    assert topo["axes"] == {"x": 2, "y": 4}
    assert mesh["topology"]["transport"] == "mesh"
    assert "[INFO] mesh: 8 x cpu (2 process(es), gloo)" in out


def test_cli_refuses_mesh2d_not_a_multiple_of_the_ranks(capfd):
    argv = ["gen:12", "--platform=cpu", "--mesh2d=2x3", "--runs=1", "--warmup=0"]
    assert dist.launch_local(_cli_in_group, 4, argv, device="cpu") == 2
    assert "--mesh2d=2x3 has 6 blocks, not a multiple of the group's 4 ranks" in \
        capfd.readouterr().err

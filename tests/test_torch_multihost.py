"""Ranks that each drive a mesh of local devices (``dist.make_rank_mesh``): the port's
counterpart of tests/test_multihost.py, where 2 processes × 4 CPU devices join one
8-device JAX runtime.

Here 2 gloo ranks (``dist.launch_local``) each drive 4 CPU shards of one 8-shard band
mesh: halos copied between a rank's own shards, one row each way between the ranks, every
dot's partials gathered and added in global shard order.  f64.  One group of ranks runs
every solve of the file (the ``ranks`` fixture); the tests read its results.  Bars:

- at g = 32 and at the padded g = 30, the classic loop (``stencil5``), the recompute loop
  (``stencil5-const``, g = 32) and the stepped loop: x gathered to rank 0 bit for bit the
  one-process 8-shard mesh's (so its Sum and Norm2 too), in as many iterations, and within
  1e-12 of the JAX package's ``cg_solve_sharded`` on the conftest's 8-device mesh with
  equal iterations;
- ``dist.rank_time_stats`` after a barrier: two ``per_process_ms`` entries;
- ``dist.describe_mesh``: two processes, each shard's process as JAX numbers them
  (process 0's devices first), and each rank driving its own four shards;
- the refusals on a mesh across ranks: ``graph=True``, ``per_shard=True`` and ``csr`` on
  a 2-D mesh of several blocks a rank, which runs on row bands only (ValueError); the
  CLI's ``--chips=6`` on 4 ranks (rc 2);
- the multichip CLI with ``--chips=8`` on 2 ranks: Sum/Norm2 and iterations bit for bit
  the one-process CLI's, its topology the gloo transport over 8 shards and 2 processes.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests.
"""

import json
import time

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.cli import cg_solver_multichip as port_cli
from tpusparse_torch.solvers import cg_sharded

F64 = torch.float64
RANKS, SHARDS = 2, 8
# name -> (grid, loop, solver arguments)
CASES = {
    "classic 32": (32, "solve", dict(mode="stencil5")),
    "classic 30": (30, "solve", dict(mode="stencil5")),
    "recompute 32": (32, "solve", dict(mode="stencil5-const")),
    "stepped 32": (32, "stepped", dict(mode="stencil5")),
    "stepped 30": (30, "stepped", dict(mode="stencil5")),
}
SOLVERS = {"solve": cg_sharded.cg_solve_sharded,
           "stepped": cg_sharded.cg_solve_sharded_stepped}


def _refusal(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


def _rank(device, cases):
    """Every case on this rank's four shards of the 8-shard mesh; rank 0 returns
    {case: (x gathered, iterations)} and what the other tests read."""
    del device
    mesh = dist.make_rank_mesh(SHARDS, devices="cpu")
    out = {}
    for name, (g, loop, kw) in cases.items():
        x, s = SOLVERS[loop](g, mesh=mesh, dtype=F64, **kw)
        out[name] = (dist.gather_to_host(x, rows=g), s.iterations)
        cg_sharded.clear_caches()
    op = cg_sharded.make_mesh_operator(32, mesh, mode="stencil5", dtype=F64)
    dist.barrier()
    t0 = time.perf_counter()
    op.solve()
    out["rank times"] = dist.rank_time_stats(time.perf_counter() - t0)
    out["describe"] = dist.describe_mesh(mesh)
    out["local"] = dist._all_objects(list(mesh.local))
    out["refusals"] = {
        "graph=True": _refusal(lambda: op.solve(graph=True)),
        "per_shard=True": _refusal(lambda: op.solve(per_shard=True)),
        "csr 2-D": _refusal(lambda: cg_sharded.make_mesh_operator(
            16, dist.make_rank_mesh((2, 4), devices="cpu"), mode="csr")),
    }
    cg_sharded.clear_caches()
    return out if dist.rank() == 0 else None


@pytest.fixture(scope="module")
def ranks():
    return dist.launch_local(_rank, RANKS, CASES, device="cpu")


def _one_process(g, loop, kw):
    x, s = SOLVERS[loop](g, mesh=dist.make_band_mesh(SHARDS, devices="cpu"), dtype=F64,
                         **kw)
    cg_sharded.clear_caches()
    return x.numpy(), s.iterations


def _jax(g, loop, kw):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    mesh = jax.make_mesh((SHARDS,), ("x",), devices=jax.devices()[:SHARDS])
    solve = jcs.cg_solve_sharded if loop == "solve" else jcs.cg_solve_sharded_stepped
    x, s = solve(mesh, g, dtype=jnp.float64, **kw)
    return np.asarray(x, np.float64), s


@pytest.mark.parametrize("name", list(CASES))
def test_rank_mesh_equals_one_process_mesh(ranks, name):
    x, k = ranks[name]
    want, k_want = _one_process(*CASES[name])
    assert k == k_want and x.shape == want.shape == (CASES[name][0],) * 2
    np.testing.assert_array_equal(x, want)
    assert x.sum() == want.sum() and np.linalg.norm(x) == np.linalg.norm(want)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_mesh_matches_jax(ranks, name):
    x, k = ranks[name]
    xj, sj = _jax(*CASES[name])
    assert sj.converged and k == sj.iterations
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-14)


def test_rank_time_stats_has_every_process(ranks):
    rt = ranks["rank times"]
    assert len(rt["per_process_ms"]) == RANKS
    assert rt["solve_time_max_ms"] >= rt["solve_time_min_ms"] > 0
    assert 0.0 <= rt["load_imbalance_pct"] <= 100.0


def test_describe_mesh_matches_jax_process_of_device(ranks):
    """JAX numbers the global devices process by process, so 2 processes × 4 devices give
    process_of_device [0, 0, 0, 0, 1, 1, 1, 1] (tests/test_multihost.py's mesh); the
    port's rank mesh places its shards the same way."""
    import jax

    from tpusparse import dist as jdist

    d = ranks["describe"]
    assert set(d) - {"devices"} == set(jdist.describe_mesh(jdist.make_band_mesh(1)))
    assert d["num_processes"] == RANKS and d["num_devices"] == SHARDS
    assert d["axes"] == {"x": SHARDS} and d["device_kinds"] == ["cpu"]
    per = jax.device_count() // RANKS
    assert d["process_of_device"] == [i // per for i in range(SHARDS)]
    assert ranks["local"] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("what", ["graph=True", "per_shard=True", "csr 2-D"])
def test_rank_mesh_refusals(ranks, what):
    words = {"graph=True": "eager loop", "per_shard=True": "eager loop",
             "csr 2-D": "stencil modes"}[what]
    assert ranks["refusals"][what] is not None and words in ranks["refusals"][what]


def test_rank_mesh_needs_a_multiple_of_the_ranks():
    with pytest.raises(ValueError, match="multiple of 1"):
        dist.make_rank_mesh(-1, devices="cpu")
    m = dist.make_rank_mesh(3, devices="cpu")  # outside a group: one process drives all
    assert m.processes == 1 and m.local == range(3) and m.shape == (3,)


# --------------------------------------------------------------------------- the CLI


def _cli_json_in_group(device, argv, path):
    rc = port_cli.main([*argv, f"--json={path}"])
    return rc, (json.loads(path.read_text()) if dist.rank() == 0 else None)


def _cli_in_group(device, argv):
    return port_cli.main(argv)


def test_cli_chips_across_ranks(tmp_path, capfd):
    """``--chips=8`` on 2 ranks: each rank drives 4 shards; rank 0 reports Sum/Norm2 bit
    for bit the one-process 8-shard CLI's, the gloo transport over 8 shards and 2
    processes, and both ranks' times."""
    argv = ["gen:16", "--dtype=f64", "--runs=3", "--warmup=0", "--platform=cpu",
            f"--chips={SHARDS}"]
    rc, ranks = dist.launch_local(_cli_json_in_group, RANKS, argv, tmp_path / "ranks.json",
                                  device="cpu")
    out = capfd.readouterr().out
    rc_m = port_cli.main([*argv, f"--json={tmp_path / 'mesh.json'}"])
    mesh = json.loads((tmp_path / "mesh.json").read_text())
    assert rc == rc_m == 0
    assert ranks["validation"] == mesh["validation"]
    assert ranks["convergence"] == mesh["convergence"]
    topo = ranks["topology"]
    assert topo["transport"] == "gloo" and topo["num_devices"] == SHARDS
    assert topo["num_processes"] == RANKS and topo["process_of_device"] == [0] * 4 + [1] * 4
    assert ranks["solver"] == mesh["solver"] == f"tpusparse-cg-sharded-{SHARDS}chip"
    assert len(ranks["timing"]["per_process_ms"]) == RANKS
    assert f"[INFO] mesh: {SHARDS} x cpu ({RANKS} process(es), gloo)" in out
    assert out.count("Iterations:") == 1


def test_cli_refuses_chips_not_a_multiple_of_the_ranks(capfd):
    argv = ["gen:16", "--platform=cpu", "--chips=6", "--runs=1", "--warmup=0"]
    assert dist.launch_local(_cli_in_group, 4, argv, device="cpu") == 2
    assert "--chips=6 is not a multiple of the group's 4 ranks" in capfd.readouterr().err

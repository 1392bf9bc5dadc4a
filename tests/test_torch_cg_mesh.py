"""The port's sharded CG over a mesh of devices in one process (``cg_sharded.MeshOperator``,
the solvers' ``mesh=``) against the JAX package's sharded CG on a mesh of as many of the
conftest's virtual CPU devices (Pallas in interpret mode), and against the port's own gloo
ranks.

Both packages on the CPU: the port's mesh is N CPU shards in this process, each running
the kernels' plain twins, as the JAX tests run their mesh on 8 virtual CPU devices in one
process.  f64 unless a case says otherwise.  Bars:

- row bands on N = 1, 2, 4 and 8 shards (``stencil5``, ``stencil5-const`` recompute and
  classic, ``csr``; the padded g = 30 on 4), 2-D blocks on (2, 2), (1, 4), (4, 1) and
  (2, 4) (``stencil5``, ``stencil5-const``), and the stepped twins on bands and blocks:
  identical iterations and x to 1e-12, the bars of tests/test_torch_cg_sharded*.py;
- a bf16 state's classic loop on 2 shards: the bars of
  ``test_torch_cg_sharded.py::test_sharded_bf16_matches_jax`` (iterations within one,
  Sum/Norm2 to 1e-3 of JAX's);
- against the gloo ranks (``dist.launch_local``) on the same decomposition, bands and
  blocks, classic, recompute, csr, bf16 and stepped: the same iterations and x bit for
  bit (both add the shards' partial dots in shard order), the per-card loop
  (``per_shard=True``) too;
- the eager loop (every solve on the CPU) reads its flag once an iteration, counted in
  ``cg.COUNTS``; the halo counters: every shard with a neighbour exchanged rows once an
  iteration and handed them to its kernels; ``describe_mesh`` has the JAX function's
  keys and values; operators are cached; the refusals (bf16 recompute, ``csr`` or a grid
  that does not divide on a 2-D mesh, ``recompute_ap`` on blocks, ``graph=True`` without
  a card, a mesh of three axes, a default mesh without a card); ``bench.mesh_scaling``
  runs both of its meshes on the CPU and refuses to run without four cards, and
  ``bench.shard_kernels`` times its kernels there.

The spawned gloo ranks import this module, so it imports JAX and the JAX package only
inside its tests and fixtures.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg, cg_sharded

F64 = torch.float64
BAND_SHARDS = (1, 2, 4, 8)
BLOCKS = ((2, 2), (1, 4), (4, 1), (2, 4))
G_BLOCKS = 24
# row-band cases: name -> (grid, the solver's arguments)
BANDS = {
    "stencil5": (16, dict(mode="stencil5")),
    "stencil5-const": (16, dict(mode="stencil5-const")),
    "stencil5-const classic": (16, dict(mode="stencil5-const", recompute_ap=False)),
    "csr": (32, dict(mode="csr")),
}


def _mesh(shape):
    return dist.make_mesh(shape, ("x", "y")[:len(shape)], devices="cpu")


def _port(shape, g, kind="solve", **kw):
    """The mesh solve on the CPU: (x as numpy, CGStats, cg.COUNTS of the solve)."""
    kw.setdefault("dtype", F64)
    cg.reset_counts()
    if kind == "stepped":
        solve = (cg_sharded.cg_solve_sharded_2d_stepped if len(shape) == 2
                 else cg_sharded.cg_solve_sharded_stepped)
    else:
        solve = (cg_sharded.cg_solve_sharded_2d if len(shape) == 2
                 else cg_sharded.cg_solve_sharded)
    if len(shape) == 2:
        x, s = solve(_mesh(shape), g, **kw)
    else:
        x, s = solve(g, mesh=_mesh(shape), **kw)
    counts = dict(cg.COUNTS)
    cg_sharded.clear_caches()
    return x.float().numpy().astype(np.float64) if x.dtype == torch.bfloat16 else x.numpy(), \
        s, counts


def _jax(shape, g, kind="solve", **kw):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, ("x", "y")[:len(shape)], devices=jax.devices()[:n])
    kw["dtype"] = {torch.bfloat16: jnp.bfloat16}.get(kw.get("dtype"), jnp.float64)
    if len(shape) == 2:
        solve = (jcs.cg_solve_sharded_2d_stepped if kind == "stepped"
                 else jcs.cg_solve_sharded_2d)
    else:
        solve = jcs.cg_solve_sharded_stepped if kind == "stepped" else jcs.cg_solve_sharded
    x, s = solve(mesh, g, **kw)
    return np.asarray(x, np.float64), s


def _close(x, want, rtol=1e-12):
    np.testing.assert_allclose(x, want, rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("case", list(BANDS))
@pytest.mark.parametrize("n", BAND_SHARDS)
def test_mesh_bands_match_jax(n, case):
    g, kw = BANDS[case]
    x, s, counts = _port((n,), g, **kw)
    xj, sj = _jax((n,), g, **kw)
    assert s.converged and sj.converged and s.iterations == sj.iterations
    assert x.shape == (g, g)
    _close(x, xj)
    # the eager loop: its flag once an iteration and once more, then the closing read
    assert counts == {"host_reads": s.iterations + 2, "replays": 0, "solves": 1, "captures": 0}


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const", "csr"])
def test_mesh_padded_grid_matches_jax(mode):
    """g = 30 on 4 shards: two zero pad rows on the last, dropped from the global x;
    stencil5-const runs as stencil5, as in JAX."""
    x, s, _ = _port((4,), 30, mode=mode)
    xj, sj = _jax((4,), 30, mode=mode)
    op = cg_sharded.make_mesh_operator(30, _mesh((4,)), mode=mode)
    assert op.mode == ("stencil5" if mode == "stencil5-const" else mode) and op.row_pad == 2
    cg_sharded.clear_caches()
    assert x.shape == (30, 30) and s.iterations == sj.iterations
    _close(x, xj)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const"])
@pytest.mark.parametrize("shape", BLOCKS)
def test_mesh_blocks_match_jax(shape, mode):
    x, s, counts = _port(shape, G_BLOCKS, mode=mode)
    xj, sj = _jax(shape, G_BLOCKS, mode=mode)
    assert s.converged and s.iterations == sj.iterations
    _close(x, xj)
    assert counts["host_reads"] == s.iterations + 2


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_mesh_stepped_matches_jax(shape):
    g = 16 if len(shape) == 1 else G_BLOCKS
    x, s, counts = _port(shape, g, kind="stepped", mode="stencil5")
    xj, sj = _jax(shape, g, kind="stepped", mode="stencil5")
    assert s.converged and s.iterations == sj.iterations
    _close(x, xj)
    assert min(s.halo_time_ms, s.spmv_time_ms, s.allreduce_time_ms, s.blas1_time_ms) > 0
    assert s.reduction_time_ms == s.allreduce_time_ms
    # its reads are its own, of the dots; the stepped loop opens no solve span
    assert counts == {"host_reads": 0, "replays": 0, "solves": 0, "captures": 0}


def test_mesh_bf16_matches_jax():
    """A bf16 state's classic loop on 2 shards, against JAX's at bf16 on 2 devices."""
    x, s, _ = _port((2,), 32, mode="stencil5", dtype=torch.bfloat16)
    xj, sj = _jax((2,), 32, mode="stencil5", dtype=torch.bfloat16)
    assert s.converged and sj.converged and abs(s.iterations - sj.iterations) <= 1
    np.testing.assert_allclose(x.sum(), xj.sum(), rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(xj), rtol=1e-3)


# the cases held bit for bit against the gloo ranks: name -> (shards, mesh shape of the
# gloo ranks or None for bands, grid, solve kind, the solver's arguments)
GLOO = {
    "stencil5 x2": (2, None, 16, "solve", dict(mode="stencil5")),
    "const recompute x2": (2, None, 16, "solve", dict(mode="stencil5-const")),
    "bf16 stencil5 x2": (2, None, 32, "solve", dict(mode="stencil5", dtype=torch.bfloat16)),
    "stencil5 x4": (4, None, 16, "solve", dict(mode="stencil5")),
    "const recompute x4": (4, None, 16, "solve", dict(mode="stencil5-const")),
    "const classic x4": (4, None, 16, "solve",
                         dict(mode="stencil5-const", recompute_ap=False)),
    "csr x4": (4, None, 32, "solve", dict(mode="csr")),
    "stepped x4": (4, None, 16, "stepped", dict(mode="stencil5")),
    "2x2 stencil5": (4, (2, 2), G_BLOCKS, "solve", dict(mode="stencil5")),
    "2x2 const": (4, (2, 2), G_BLOCKS, "solve", dict(mode="stencil5-const")),
    "2x2 bf16": (4, (2, 2), 32, "solve", dict(mode="stencil5", dtype=torch.bfloat16)),
    "2x2 stepped": (4, (2, 2), G_BLOCKS, "stepped", dict(mode="stencil5")),
}


def _gloo_cases(device, names):
    """Every named case on this gloo rank; rank 0 returns {name: (x, iterations)}."""
    out = {}
    for name in names:
        _n, blocks, g, kind, kw = GLOO[name]
        kw = {"dtype": F64, **kw}
        if blocks is not None:
            solve = (cg_sharded.cg_solve_sharded_2d_stepped if kind == "stepped"
                     else cg_sharded.cg_solve_sharded_2d)
            x, s = solve(blocks, g, device=device, **kw)
            x = dist.gather_blocks_to_host(x, blocks)
        else:
            solve = (cg_sharded.cg_solve_sharded_stepped if kind == "stepped"
                     else cg_sharded.cg_solve_sharded)
            x, s = solve(g, device=device, **kw)
            x = dist.gather_to_host(x, rows=g)
        out[name] = (x, s.iterations)
        cg_sharded.clear_caches()
    return out


@pytest.fixture(scope="module")
def gloo():
    """{case: (x, iterations)} of the gloo ranks, one group a shard count."""
    out = {}
    for n in (2, 4):
        names = [name for name, case in GLOO.items() if case[0] == n]
        out.update(dist.launch_local(_gloo_cases, n, names, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(GLOO))
def test_mesh_equals_gloo_ranks(gloo, name):
    n, blocks, g, kind, kw = GLOO[name]
    x, s, _ = _port(blocks or (n,), g, kind=kind, **kw)
    xg, its = gloo[name]
    assert s.iterations == its
    np.testing.assert_array_equal(x, np.asarray(xg, np.float64))


@pytest.mark.parametrize("name", [n for n, c in GLOO.items() if c[3] == "solve"])
def test_per_card_loop_equals_gloo_ranks(gloo, name):
    """The per-card loop (``per_shard=True``: a graph a shard on a card, here its twins)
    against the gloo ranks of the same decomposition: the same iterations, x bit for bit."""
    n, blocks, g, _kind, kw = GLOO[name]
    x, s, counts = _port(blocks or (n,), g, per_shard=True, **kw)
    xg, its = gloo[name]
    assert s.iterations == its
    assert counts == {"host_reads": 1, "replays": 0, "solves": 1, "captures": 0}
    np.testing.assert_array_equal(x, np.asarray(xg, np.float64))


@pytest.mark.parametrize("case", ["stencil5", "stencil5-const"])
def test_mesh_kernels_read_exchanged_halo_rows(case):
    """4 shards of 4 rows: each shard with a neighbour exchanged rows once an iteration;
    the classic loop's SpMV (three row pieces) hands exchanged rows to one piece on an end
    shard and two on an inner one, the recompute loop to K1 and K2 on every shard."""
    cg_sharded.reset_halo_calls()
    _x, s, _ = _port((4,), 16, mode=case)
    k = s.iterations
    want = dict.fromkeys(cg_sharded.HALO_CALLS, 0)
    want["exchange"] = 4 * k
    if case == "stencil5":
        want["spmv_stencil5"] = (1 + 2 + 2 + 1) * k
    else:
        want["spmv_stencil5_const_pupdate_dot"] = want["cg_const_update_recompute"] = 4 * k
    assert cg_sharded.HALO_CALLS == want


def test_mesh_blocks_exchange_columns():
    """A 2 x 2 mesh: every block has one N/S and one W/E neighbour, so each exchange
    brings it a row and a column, and each column reaches its side-column correction."""
    cg_sharded.reset_halo_calls()
    _x, s, _ = _port((2, 2), G_BLOCKS, mode="stencil5")
    k = s.iterations
    calls = cg_sharded.HALO_CALLS
    assert calls["exchange"] == calls["column_exchange"] == calls["column_correction"] \
        == 4 * k
    assert calls["spmv_stencil5"] == 4 * k


def test_describe_mesh_matches_jax():
    import jax

    from tpusparse import dist as jdist

    for shape in ((4,), (2, 2)):
        axes = ("x", "y")[:len(shape)]
        jmesh = jax.make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
        want, got = jdist.describe_mesh(jmesh), dist.describe_mesh(_mesh(shape))
        assert set(want) <= set(got)
        for key in ("axes", "num_devices", "num_processes", "process_of_device"):
            assert got[key] == want[key], key
        assert got["device_kinds"] == ["cpu"] and got["devices"] == ["cpu"] * len(
            got["process_of_device"])


def test_meshes_and_their_operators():
    """Mesh shapes, devices and the operator cache."""
    assert dist.make_band_mesh(0, devices="cpu").shape == (1,)
    m = dist.make_band_mesh(3, devices=["cpu"])
    assert m.shape == (3,) and m.devices == (torch.device("cpu"),) * 3
    assert m.shards_per_card() == 0 and dist.make_mesh((2, 3), devices="cpu").size == 6
    op = cg_sharded.make_mesh_operator(16, m)
    assert cg_sharded.make_mesh_operator(16, m) is op
    assert [sh.row_lo for sh in op.shards] == [0, 6, 12] and op.row_pad == 2
    assert not op.one_card and op.device == torch.device("cpu")
    cg_sharded.clear_caches()
    assert cg_sharded.make_mesh_operator(16, m) is not op
    cg_sharded.clear_caches()


def test_mesh_given_b_matches_jax():
    """A whole right-hand side (seeded) cut into the shards' bands."""
    import jax.numpy as jnp

    b = np.random.RandomState(4).rand(16, 16)
    x, s, _ = _port((4,), 16, mode="stencil5", b=b)
    xj, sj = _jax((4,), 16, mode="stencil5", b=jnp.asarray(b))
    assert s.iterations == sj.iterations
    _close(x, xj)


REFUSALS = {
    "bf16 recompute": (ValueError, "bf16", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5-const", dtype=torch.bfloat16, mesh=_mesh((2,)))),
    "csr on blocks": (ValueError, "stencil modes", lambda: cg_sharded.cg_solve_sharded_2d(
        _mesh((2, 2)), 16, mode="csr")),
    "grid that does not divide": (ValueError, "must divide",
                                  lambda: cg_sharded.cg_solve_sharded_2d(_mesh((1, 4)), 18)),
    "recompute on blocks": (ValueError, "recompute_ap", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5-const", recompute_ap=True,
        operator=cg_sharded.make_mesh_operator(16, _mesh((2, 2)), mode="stencil5-const"))),
    "graph without a card": (ValueError, "graph=True", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5", mesh=_mesh((2,)), graph=True)),
    "three axes": (ValueError, "1-D or 2-D", lambda: cg_sharded.make_mesh_operator(
        16, dist.make_mesh((2, 1, 1), ("x", "y", "z"), devices="cpu"))),
    "a 1-D mesh to the 2-D solver": (ValueError, "2-axis",
                                     lambda: cg_sharded.cg_solve_sharded_2d(_mesh((4,)), 16)),
}


@pytest.mark.parametrize("why", list(REFUSALS))
def test_mesh_refusals(why):
    exc, words, call = REFUSALS[why]
    with pytest.raises(exc, match=words):
        call()
    cg_sharded.clear_caches()


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.make_band_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.make_mesh((2, 2))


def test_mesh_scaling_script_runs_both_meshes(tmp_path, monkeypatch):
    """``bench.mesh_scaling`` on the CPU: every case on both meshes, x bit for bit; it
    refuses to run without four cards."""
    import json

    from tpusparse_torch.bench import mesh_scaling

    out = tmp_path / "scaling.json"
    assert mesh_scaling.main(["--grid=16", "--runs=1", "--platform=cpu",
                              f"--json={out}"]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == len(mesh_scaling.CASES) and all(r["x_equal"] for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh_scaling.main(["--grid=16"]) == 1


def test_shard_kernels_script_times_both(tmp_path):
    """``bench.shard_kernels`` on the CPU: every kernel on the whole field and on the
    shards' fields; a grid that does not divide returns 2."""
    import json

    from tpusparse_torch.bench import shard_kernels

    out = tmp_path / "shards.json"
    assert shard_kernels.main(["--grid=32", "--reps=1", "--platform=cpu",
                               f"--json={out}"]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == len(shard_kernels._passes())
    assert all(r["whole_ms"] > 0 and r["shards_ms"] > 0 for r in rows)
    assert shard_kernels.main(["--grid=30", "--platform=cpu"]) == 2

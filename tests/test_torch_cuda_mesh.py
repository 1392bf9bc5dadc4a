"""The sharded CG over a mesh of shards that one process drives (``cg_sharded.MeshOperator``)
on one card: every shard's kernels on it, the loop replayed from one CUDA graph.

Every test here is marked ``cuda`` and skips without a card.  The file imports no JAX (run
it where JAX is not installed as tests/test_torch_cuda.py is run:
``python -m pytest tests/test_torch_cuda_mesh.py -q -m cuda --noconftest``).

- the graph loop against the mesh's eager loop (``graph=False``) in every loop, mode,
  dtype and decomposition the mesh runs, at g = 256: the same iterations and every
  shard's x bit for bit, one replay and one read a solve (the eager loop: one read an
  iteration and two more), the replays' launches k times one captured iteration's, the
  halo counts equal to the eager loop's;
- the mesh against gloo ranks sharing the card on the same decomposition: iterations
  equal, x bit for bit;
- a capture whose iteration allocates raises; the mesh solves again afterwards;
- the multichip CLI over a 4-shard mesh: one replay and one read a solve.
"""

import json

import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.kernels import blas1, ell
from tpusparse_torch.kernels import stencil5 as st5
from tpusparse_torch.solvers import cg, cg_sharded

pytestmark = pytest.mark.cuda

G = 256
F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16
# label -> (mesh shape, mode, dtype, the solve's loop arguments)
CASES = {
    "stencil5 f64 x1": ((1,), "stencil5", F64, {}),
    "stencil5 f64 x2": ((2,), "stencil5", F64, {}),
    "const f64 recompute x4": ((4,), "stencil5-const", F64, {}),
    "const f32 recompute x2": ((2,), "stencil5-const", F32, {}),
    "const f32 classic x4": ((4,), "stencil5-const", F32, {"recompute_ap": False}),
    "csr f64 x4": ((4,), "csr", F64, {}),
    "bf16c f32 x4": ((4,), "stencil5-bf16c", F32, {}),
    "stencil5 bf16 x2": ((2,), "stencil5", BF16, {}),
    "stencil5 f64 2x2": ((2, 2), "stencil5", F64, {}),
    "const f64 2x2": ((2, 2), "stencil5-const", F64, {}),
    "stencil5 f32 1x4": ((1, 4), "stencil5", F32, {}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _mesh(shape):
    return dist.make_mesh(shape, ("x", "y")[:len(shape)])


def _solve(op, **kw):
    """One solve with its counts: (xs, CGStats, cg.COUNTS, cg.LAUNCHES, HALO_CALLS)."""
    for c in (cg, st5, blas1, ell):
        c.reset_launches()
    cg.reset_counts()
    cg_sharded.reset_halo_calls()
    xs, s = op.solve(**kw)
    return xs, s, dict(cg.COUNTS), dict(cg.LAUNCHES), dict(cg_sharded.HALO_CALLS)


@pytest.mark.parametrize("label", list(CASES))
def test_mesh_graph_equals_eager_on_card(dev, label):
    shape, mode, dtype, kw = CASES[label]
    op = cg_sharded.make_mesh_operator(G, _mesh(shape), mode=mode, dtype=dtype)
    assert op.one_card and op.mesh.shards_per_card() == op.mesh.size
    xs_e, s_e, counts_e, _, halo_e = _solve(op, graph=False, **kw)
    assert counts_e == {"host_reads": s_e.iterations + 2, "replays": 0}
    for _ in range(2):  # the capture, then a replay of the cached graph
        xs, s, counts, replayed, halo = _solve(op, **kw)
        assert s.converged and s.iterations == s_e.iterations
        assert all(torch.equal(a, b) for a, b in zip(xs, xs_e))
        assert counts == {"host_reads": 1, "replays": 1}
        (loop,) = [lp for lp in op.graphs.values() if lp.graphed]
        per = loop.per_iteration
        assert {n: v for n, v in replayed.items() if n != "cg_cond"} == \
            {n: s.iterations * v for n, v in per.items()}
        assert replayed["cg_cond"] == 1 + cg.UNROLL * -(-s.iterations // cg.UNROLL)
        updates = ("spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute") \
            if loop.loop == "recompute" else ("cg_update", "p_update")
        assert all(per[n] == op.mesh.size for n in updates), per
        assert halo == halo_e
        del xs
    cg_sharded.clear_caches()


def _gloo_on_card(device, g, cases):
    """Each case on this gloo rank of a group sharing the card; rank 0 returns {case: (x
    on the host, iterations)}."""
    out = {}
    for name, (blocks, mode, dtype, kw) in cases.items():
        if blocks is None:
            x, s = cg_sharded.cg_solve_sharded(g, mode=mode, dtype=dtype, device=device, **kw)
            x = dist.gather_to_host(x, rows=g)
        else:
            x, s = cg_sharded.cg_solve_sharded_2d(blocks, g, mode=mode, dtype=dtype,
                                                  device=device, **kw)
            x = dist.gather_blocks_to_host(x, blocks)
        out[name] = (x, s.iterations)
        cg_sharded.clear_caches()
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_equals_gloo_ranks_on_card(dev, n):
    """The mesh's graph loop against n gloo ranks sharing the card: bands in the classic,
    recompute and csr loops and a bf16 state, and on 4 a 2 x 2 mesh: x bit for bit."""
    cases = {"stencil5 f64": (None, "stencil5", F64, {}),
             "const f64 recompute": (None, "stencil5-const", F64, {}),
             "csr f64": (None, "csr", F64, {}),
             "stencil5 bf16": (None, "stencil5", BF16, {})}
    if n == 4:
        cases["2x2 stencil5 f64"] = ((2, 2), "stencil5", F64, {})
        cases["2x2 const f32"] = ((2, 2), "stencil5-const", F32, {})
    got = dist.launch_local(_gloo_on_card, n, G, cases, device="cuda")
    for name, (blocks, mode, dtype, kw) in cases.items():
        op = cg_sharded.make_mesh_operator(G, _mesh(blocks or (n,)), mode=mode, dtype=dtype)
        cg.reset_counts()
        x, s = cg_sharded.cg_solve_sharded(G, operator=op, **kw)
        assert cg.COUNTS == {"host_reads": 1, "replays": 1}, name
        xg, its = got[name]
        assert s.iterations == its, name
        assert torch.equal(x.float().cpu() if dtype == BF16 else x.cpu(),
                           torch.from_numpy(xg)), name
    cg_sharded.clear_caches()


def test_mesh_capture_that_allocates_raises(dev, monkeypatch):
    """An iteration whose ordered sum allocates its result (as ``a + b`` does) cannot be
    captured: the capture raises, and nothing falls back."""
    op = cg_sharded.make_mesh_operator(G, _mesh((4,)), mode="stencil5", dtype=F64)
    _xs, s_e = op.solve(graph=False)  # leaves the allocator small blocks to hand out

    def allocating(parts):
        total = parts[0]
        for t in parts[1:]:
            total = total + t
        return total

    monkeypatch.setattr(cg_sharded, "_sum_in_order", allocating)
    with pytest.raises(RuntimeError, match="allocated"):
        op.solve()
    monkeypatch.undo()
    cg_sharded.clear_caches()
    op = cg_sharded.make_mesh_operator(G, _mesh((4,)), mode="stencil5", dtype=F64)
    _xs, s = op.solve()
    assert s.converged and s.iterations == s_e.iterations
    cg_sharded.clear_caches()


def test_mesh_cli_reads_once_a_solve(dev, tmp_path):
    """The multichip CLI over 4 shards sharing the card: one replay and one read in each
    of its 5 solves (1 warm-up, 3 timed, the solution's), the export's topology one
    process."""
    from tpusparse_torch.cli import cg_solver_multichip

    out = tmp_path / "mesh.json"
    cg.reset_counts()
    assert cg_solver_multichip.main([f"gen:{G}", "--chips=4", "--dtype=f64", "--runs=3",
                                     "--warmup=1", f"--json={out}"]) == 0
    assert cg.COUNTS == {"host_reads": 5, "replays": 5}
    res = json.loads(out.read_text())
    assert res["topology"]["transport"] == "mesh"
    assert res["topology"]["num_processes"] == 1 and res["topology"]["num_devices"] == 4
    assert res["loop"] == "classic" and res["convergence"]["converged"]

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
- the multichip CLI over a 4-shard mesh: one replay and one read a solve;
- the per-card loop (``cg_sharded.CardLoop``, ``per_shard=True``: a graph a card, its
  shards in lockstep, meeting through ``kernels/mesh_sync.py``) against the mesh's one
  graph in every case above: the same iterations and every shard's x bit for bit, one
  replay (the card's) and one read a solve, the same kernel launches and halo counts, the
  condition kernel's included;
- the sync kernels against their twins (rows, a strided column, partials, a wait that
  sums, one that passes its bound), bit for bit;
- a shard left out of its card's graph makes the others' waits give up within the bound,
  and the solve raise (in a child process); a new loop then solves.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.kernels import blas1, ell, mesh_sync
from tpusparse_torch.kernels import stencil5 as st5
from tpusparse_torch.solvers import cg, cg_sharded

ROOT = pathlib.Path(__file__).resolve().parent.parent

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
    for c in (cg, st5, blas1, ell, mesh_sync):
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
    assert counts_e == {"host_reads": s_e.iterations + 2, "replays": 0, "solves": 1,
                        "captures": 0}
    for captures in (1, 0):  # the capture, then a replay of the cached graph
        xs, s, counts, replayed, halo = _solve(op, **kw)
        assert s.converged and s.iterations == s_e.iterations
        assert all(torch.equal(a, b) for a, b in zip(xs, xs_e))
        assert counts == {"host_reads": 1, "replays": 1, "solves": 1, "captures": captures}
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
        assert cg.COUNTS == {"host_reads": 1, "replays": 1, "solves": 1, "captures": 1}, name
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
    assert cg.COUNTS == {"host_reads": 5, "replays": 5, "solves": 5, "captures": 1}
    res = json.loads(out.read_text())
    assert res["topology"]["transport"] == "mesh"
    assert res["topology"]["num_processes"] == 1 and res["topology"]["num_devices"] == 4
    assert res["loop"] == "classic" and res["convergence"]["converged"]


@pytest.mark.parametrize("label", list(CASES))
def test_per_shard_loop_equals_mesh_loop_on_card(dev, label):
    """The per-card loop with its shards sharing the card against the mesh's one graph:
    x bit for bit, one read and one replay (the card's graph) a solve, the same launches
    of every wrapper but the sync kernels (none in the mesh's)."""
    shape, mode, dtype, kw = CASES[label]
    op = cg_sharded.make_mesh_operator(G, _mesh(shape), mode=mode, dtype=dtype)
    n = op.mesh.size
    xs_m, s_m, _, launched_m, halo_m = _solve(op, **kw)
    for captures in (1, 0):  # the captures, then replays of the cached graphs
        xs, s, counts, launched, halo = _solve(op, per_shard=True, **kw)
        assert s.converged and s.iterations == s_m.iterations
        assert all(torch.equal(a, b) for a, b in zip(xs, xs_m))
        assert counts == {"host_reads": 1, "replays": 1, "solves": 1, "captures": captures}
        sync = {k: launched.pop(k, 0) for k in mesh_sync.LAUNCHES}
        assert launched == launched_m
        rows = n > 1  # a shard's waits: its rows (with neighbours), then the two dots
        k = s.iterations
        assert sync == {"mesh_publish_rows": n * k * rows, "mesh_publish_partial": 2 * n * k,
                        "mesh_wait": (2 + rows) * n * k}
        assert halo == halo_m
        del xs
    cg_sharded.clear_caches()


def _sync_case(device, dtype, n, rng):
    """Two shards' sync state on ``device`` (twins on the CPU): shard 0 publishes a row and
    a strided column into shard 1's halo buffers and its partial into both shards'
    slots; returns what the checks read."""
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    field = torch.from_numpy(rng.standard_normal((5, 7))).to(dtype).to(device)
    halo_row, halo_col = torch.zeros(7, dtype=dtype, device=device), torch.zeros(
        5, dtype=dtype, device=device)
    ctl = torch.tensor([41, 0], dtype=torch.int64, device=device)
    flags = torch.zeros((max(n, 2), 4 + n), dtype=torch.int64, device=device)
    slots = torch.from_numpy(rng.standard_normal((max(n, 2), n))).to(acc).to(device)
    part = torch.tensor(rng.standard_normal(), dtype=acc, device=device)
    rows = mesh_sync.row_links([(field[2], halo_row, flags[1, 0]),
                                (field[:, -1], halo_col, flags[1, 2])], device)
    dests = mesh_sync.partial_links([(slots[j, 0], flags[j, 4]) for j in range(n)], device)
    mesh_sync.publish_rows(ctl, rows)
    mesh_sync.publish_partial(ctl, part, dests)
    flags[:, 5:].fill_(42)  # every other shard's partial is there
    out = torch.empty((), dtype=acc, device=device)
    mesh_sync.wait(ctl, flags[1, :4], 0b0101, 99, 10 ** 9)  # the row and the column
    ctl[0] = 41
    mesh_sync.wait(ctl, flags[0, 4:], (1 << n) - 1, 98, 10 ** 9, slots=slots[0], out=out)
    late = torch.tensor([0, 0], dtype=torch.int64, device=device)  # waits for epoch 1
    nan = torch.empty((), dtype=acc, device=device)
    mesh_sync.wait(late, flags[1, :4], 0b0010, 97, 0 if device == "cpu" else 1000,
                   slots=None)
    mesh_sync.wait(late, flags[1, 4:], 1, 96, 1000, slots=slots[1], out=nan)
    return {"halo_row": halo_row, "halo_col": halo_col, "flags": flags, "slots": slots,
            "ctl": ctl, "out": out, "late": late, "nan": nan}


@pytest.mark.parametrize("dtype", [F64, F32, BF16])
def test_sync_kernels_equal_their_twins(dev, dtype):
    import numpy as np

    for n in (1, 3, 8):
        got = _sync_case("cuda", dtype, n, np.random.default_rng(n))
        want = _sync_case("cpu", dtype, n, np.random.default_rng(n))
        for name, t in want.items():
            if name == "nan":
                assert torch.isnan(got[name].cpu()) and torch.isnan(t), name
            else:
                assert torch.equal(got[name].cpu(), t), name
        assert int(want["ctl"][0]) == 42 and int(want["late"][1]) == 97  # the bound passed
        # the sum of the slots in shard order, as the mesh adds its partials
        parts = list(want["slots"][0].unbind())
        assert torch.equal(want["out"], cg_sharded._sum_in_order(parts))


_WITHHELD = """
import json, sys, time
import torch
from tpusparse_torch import dist
from tpusparse_torch.solvers import cg_sharded
cg_sharded.WAIT_BOUND_S = float(sys.argv[1])
op = cg_sharded.make_mesh_operator(256, dist.make_band_mesh(2), mode="stencil5",
                                   dtype=torch.float64)
_, s0 = op.solve(per_shard=True)
loop = next(lp for lp in op.graphs.values() if isinstance(lp, cg_sharded.CardLoop))
loop.withheld = 1
t0 = time.perf_counter()
try:
    op.solve(per_shard=True)
    error = None
except RuntimeError as e:
    error = str(e)
seconds = time.perf_counter() - t0
_, s1 = op.solve(per_shard=True)
print(json.dumps({"error": error, "seconds": seconds, "iterations": [s0.iterations,
                                                                     s1.iterations]}))
"""


def test_withheld_shard_raises_within_the_bound(dev):
    """Shard 1 left out of the card's graph: shard 0's waits give up after the bound, the
    solve raises RuntimeError naming the wait, and a new loop then solves as before."""
    bound = 1.0
    out = subprocess.run([sys.executable, "-c", _WITHHELD, str(bound)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["error"] and "shard 0's wait" in res["error"] and "bound" in res["error"]
    assert bound <= res["seconds"] < bound + 5
    assert res["iterations"][0] == res["iterations"][1] > 0

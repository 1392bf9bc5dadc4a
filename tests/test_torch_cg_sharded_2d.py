"""The port's 2-D block-decomposed CG (tpusparse_torch.solvers.cg_sharded.cg_solve_sharded_2d
and its stepped twin) against the JAX package's, mirroring
tests/test_cg_sharded.py::Test2DDecomposition.

The port's ranks are gloo processes on the CPU (``dist.launch_local``), one per block of an
R×C mesh; the JAX side runs ``cg_solve_sharded_2d`` on a mesh of as many of the conftest's
virtual CPU devices, its Pallas kernels in interpret mode.  Mesh shapes (2, 2), (1, 4),
(4, 1) and (2, 4); each runs every one of its cases in one group of ranks, once for the
file (the ``port`` fixture).  f64 at g = 24, except the bf16-coefficient check (f32).
Bars:

- ``stencil5`` and ``stencil5-const`` against JAX on the same mesh shape and against the
  port's single-device ``cg.cg_solve``: identical iterations, x to 1e-12;
- one SpMV of a seeded random x, gathered, against ``spmv_stencil5_plain`` on the whole
  grid (y and <x, y> to 1e-12): a block whose side columns were corrected with the wrong
  sign, or whose planes were masked as if the block were its own grid, fails it;
- overlapped ≡ synchronous: that SpMV's y bit for bit, the solve's x to 1e-12;
- ``stencil5-bf16c`` ≡ ``stencil5`` f32 bit for bit; the stepped loop ≡ the device loop,
  with its four buckets > 0; plain-PyTorch updates ≡ the BLAS1 kernels' (x to 1e-12);
- the refusals (a grid that does not divide, a mesh of another size than the group, a
  mode that is not a stencil, a mesh that is not a pair), ``__graft_entry__.
  dryrun_multichip``'s 2-D leg on (2, 2) (g = 32 against the single-device solve), and
  the halo counters: every rank with a W/E neighbour exchanged columns once an iteration
  and corrected its side columns with them, every rank with a N/S neighbour exchanged
  rows and handed them to its kernels.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests and fixtures.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg_sharded

F64 = torch.float64
MESHES = ((2, 2), (1, 4), (4, 1), (2, 4))
G = 24
SEED_X = 11
MODES = ("stencil5", "stencil5-const")


def _run_cases(device, mesh, cases):
    """Every case on this rank of the group; rank 0 returns {name: result}, a solve's or
    an SpMV's with every rank's ``HALO_CALLS`` of the case under "halo calls", or a
    refusal's message."""
    out = {}
    for name, kind, kw in cases:
        cg_sharded.reset_halo_calls()
        out[name] = _run_case(device, mesh, kind, dict(kw))
        if isinstance(out[name], dict):
            out[name]["halo calls"] = dist._all_objects(dict(cg_sharded.HALO_CALLS))
    return out


def _run_case(device, mesh, kind, kw):
    g = kw.pop("grid_size", G)
    if kind == "refuse":
        try:
            cg_sharded.cg_solve_sharded_2d(kw.pop("mesh", mesh), g, device=device, dtype=F64,
                                           **kw)
        except ValueError as e:
            return str(e)
        return None
    field = kw.pop("x", None)
    solve_kw = {k: kw.pop(k) for k in ("max_iters", "use_pallas_blas1", "b") if k in kw}
    kw.setdefault("dtype", F64)
    op = cg_sharded.make_sharded_operator(g, device=device, mesh_shape=mesh, **kw)
    if kind == "spmv":
        y, pap = op.local_spmv_dot(op.band_of(field))
        return {"y": dist.gather_blocks_to_host(y, mesh), "pap": float(pap)}
    solve = (cg_sharded.cg_solve_sharded_2d_stepped if kind == "stepped"
             else cg_sharded.cg_solve_sharded_2d)
    x, s = solve(mesh, g, operator=op, **solve_kw)
    return {"x": dist.gather_blocks_to_host(x, mesh), "iterations": s.iterations,
            "converged": s.converged, "mode": op.mode, "stats": s,
            "overlapped": dist._all_objects(op.overlapped)}


def _seeded_x(g=G):
    return np.random.RandomState(SEED_X).randn(g, g)


def _cases(mesh):
    cases = [(mode, "solve", dict(mode=mode)) for mode in MODES]
    cases += [(f"sync {mode}", "solve", dict(mode=mode, overlap=False)) for mode in MODES]
    cases += [(f"spmv {mode}", "spmv", dict(mode=mode, x=_seeded_x())) for mode in MODES]
    cases += [(f"spmv sync {mode}", "spmv", dict(mode=mode, overlap=False, x=_seeded_x()))
              for mode in MODES]
    cases += [
        ("f32 stencil5", "solve", dict(mode="stencil5", dtype=torch.float32)),
        ("f32 stencil5-bf16c", "solve", dict(mode="stencil5-bf16c", dtype=torch.float32)),
        ("stepped", "stepped", dict(mode="stencil5")),
    ]
    if mesh == (2, 2):
        cases += [(f"bf16 {mode}", "solve", dict(grid_size=32, mode=mode,
                                                  dtype=torch.bfloat16)) for mode in MODES]
        cases += [("gate", "solve", dict(grid_size=32, mode="stencil5", max_iters=200)),
                  ("plain blas1", "solve", dict(mode="stencil5", use_pallas_blas1=False)),
                  ("b", "solve", dict(mode="stencil5", b=_seeded_x()))]
    if mesh == (2, 4):
        cases += [(f"refuse {why}", "refuse", kw) for why, kw in REFUSALS.items()]
    return cases


# the 2 x 4 group's refusals: reason -> the arguments and the words of the message
REFUSALS = {
    "divide": dict(grid_size=30),
    "size": dict(mesh=(2, 2)),
    "mode": dict(mode="csr"),
    "2-axis": dict(mesh=(8,)),
}
REFUSAL_WORDS = {"divide": "divide", "size": "needs 4 ranks, the group has 8",
                 "mode": "stencil modes", "2-axis": "2-axis"}


@pytest.fixture(scope="module")
def port():
    """{mesh shape: {case: result}}, each shape's cases in one group of R·C gloo ranks."""
    return {mesh: dist.launch_local(_run_cases, mesh[0] * mesh[1], mesh, _cases(mesh),
                                    device="cpu")
            for mesh in MESHES}


def _jax_solve_2d(mesh, g, mode, **kw):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    jmesh = jax.make_mesh(mesh, ("x", "y"), devices=jax.devices()[:mesh[0] * mesh[1]])
    kw.setdefault("dtype", jnp.float64)
    x, s = jcs.cg_solve_sharded_2d(jmesh, g, mode=mode, **kw)
    return np.asarray(x, np.float64), s


def _single_device(g, max_iters=1000):
    from tpusparse_torch import formats, ops
    from tpusparse_torch.solvers import cg

    st = formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=F64, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True, config=cg.CGConfig(max_iters=max_iters))
    return x.numpy(), s


def _close(x, want, rtol=1e-12):
    np.testing.assert_allclose(x, want, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
def test_2d_matches_jax(port, mesh, mode):
    res = port[mesh][mode]
    xj, sj = _jax_solve_2d(mesh, G, mode)
    assert res["converged"] and sj.converged and res["mode"] == mode
    assert res["x"].shape == xj.shape == (G, G)
    assert res["iterations"] == sj.iterations
    _close(res["x"], xj)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
def test_2d_matches_single_device(port, mesh, mode):
    res = port[mesh][mode]
    x1, s1 = _single_device(G)
    assert res["iterations"] == s1.iterations
    _close(res["x"], x1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
def test_2d_spmv_against_the_whole_grid(port, mesh, mode):
    """One SpMV on every block, gathered, against the plain stencil on the whole grid."""
    from tpusparse_torch import generate
    from tpusparse_torch.kernels import stencil5 as st5

    x = torch.from_numpy(_seeded_x())
    planes = generate.make_stencil5_planes_device(G, dtype=F64, device="cpu")
    y_ref, d_ref = st5.spmv_stencil5_plain(planes, x, with_dot=True)
    got = port[mesh][f"spmv {mode}"]
    _close(got["y"], y_ref.numpy())
    np.testing.assert_allclose(got["pap"], float(d_ref), rtol=1e-12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
def test_2d_overlap_matches_synchronous(port, mesh, mode):
    ov, sync = port[mesh][mode], port[mesh][f"sync {mode}"]
    assert ov["overlapped"] == [True] * (mesh[0] * mesh[1])  # blocks of 6 rows or more
    assert sync["overlapped"] == [False] * (mesh[0] * mesh[1])
    assert ov["iterations"] == sync["iterations"]
    _close(ov["x"], sync["x"])
    ya, yb = port[mesh][f"spmv {mode}"], port[mesh][f"spmv sync {mode}"]
    np.testing.assert_array_equal(ya["y"], yb["y"])  # every point: the same arithmetic
    np.testing.assert_allclose(ya["pap"], yb["pap"], rtol=1e-14)


@pytest.mark.parametrize("mesh", MESHES)
def test_2d_bf16_coefficients_match_f32(port, mesh):
    a, b = port[mesh]["f32 stencil5"], port[mesh]["f32 stencil5-bf16c"]
    assert a["x"].dtype == np.float32 and a["iterations"] == b["iterations"]
    np.testing.assert_array_equal(a["x"], b["x"])


def test_2d_takes_a_whole_b(port):
    """``b``: a whole (g, g) field, of which each rank takes its block, as in JAX."""
    res = port[(2, 2)]["b"]
    xj, sj = _jax_solve_2d((2, 2), G, "stencil5", b=_seeded_x())
    assert res["converged"] and res["iterations"] == sj.iterations
    _close(res["x"], xj)


def test_2d_plain_blas1_matches_the_kernels(port):
    """``use_pallas_blas1=False``: the classic loop's updates as plain PyTorch ops."""
    a, b = port[(2, 2)]["plain blas1"], port[(2, 2)]["stencil5"]
    assert a["converged"] and a["iterations"] == b["iterations"]
    _close(a["x"], b["x"])


@pytest.mark.parametrize("mesh", MESHES)
def test_2d_stepped_matches_device_loop(port, mesh):
    fused, stepped = port[mesh]["stencil5"], port[mesh]["stepped"]
    assert stepped["converged"] and stepped["iterations"] == fused["iterations"]
    _close(stepped["x"], fused["x"])
    s = stepped["stats"]
    assert min(s.halo_time_ms, s.spmv_time_ms, s.allreduce_time_ms, s.blas1_time_ms) > 0
    assert s.reduction_time_ms == s.allreduce_time_ms
    assert s.halo_time_ms + s.spmv_time_ms + s.allreduce_time_ms + s.blas1_time_ms \
        <= s.total_time_ms


@pytest.mark.parametrize("why", list(REFUSALS))
def test_2d_refusals(port, why):
    """On the 2 x 4 group, as JAX ``_check_2d_mesh`` refuses, and a mesh whose size is not
    the group's."""
    assert REFUSAL_WORDS[why] in port[(2, 4)][f"refuse {why}"]


def test_2d_refuses_without_a_group():
    """Outside a group there is one rank: only a 1 x 1 mesh fits it."""
    with pytest.raises(ValueError, match="needs 4 ranks, the group has 1"):
        cg_sharded.make_sharded_operator(8, mesh_shape=(2, 2), device="cpu")
    x, s = cg_sharded.cg_solve_sharded_2d((1, 1), 8, dtype=F64, device="cpu")
    x1, s1 = _single_device(8)
    assert s.iterations == s1.iterations
    np.testing.assert_array_equal(x.numpy(), x1)  # the same kernels (twins) and dots
    cg_sharded.clear_caches()


def test_2d_dryrun_multichip_gate(port):
    """``__graft_entry__.dryrun_multichip``'s 2-D leg on (2, 2): g = 8·4 against the
    single-device solve, identical iterations, Sum/Norm2 to 1e-12."""
    got = port[(2, 2)]["gate"]
    x1, s1 = _single_device(32, max_iters=200)
    assert got["converged"] and got["iterations"] == s1.iterations
    assert got["x"].shape == x1.shape
    np.testing.assert_allclose(got["x"].sum(), x1.sum(), rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got["x"]), np.linalg.norm(x1), rtol=1e-12)


HALO_KERNEL = {"stencil5": "spmv_stencil5", "stencil5-const": "spmv_stencil5_const",
               "sync stencil5": "spmv_stencil5", "stepped": "spmv_stencil5"}


@pytest.mark.parametrize("case", list(HALO_KERNEL))
@pytest.mark.parametrize("mesh", MESHES)
def test_2d_halo_counters(port, mesh, case):
    """Each rank: one row exchange an iteration if it has a N/S neighbour, its kernel
    given the exchanged rows (the overlapped SpMV's first and last row pieces each take
    one, the synchronous block both at once); one column exchange an iteration if it has
    a W/E neighbour, and one side-column correction for each such neighbour."""
    res = port[mesh][case]
    nr, nc = mesh
    its = res["iterations"]
    overlapped = case != "sync stencil5"
    for r, calls in enumerate(res["halo calls"]):
        i, j = divmod(r, nc)
        rows = (i > 0) + (i < nr - 1)
        cols = (j > 0) + (j < nc - 1)
        want = dict.fromkeys(cg_sharded.HALO_CALLS, 0)
        want["exchange"] = its if rows else 0
        want[HALO_KERNEL[case]] = its * (rows if overlapped else min(rows, 1))
        want["column_exchange"] = its if cols else 0
        want["column_correction"] = its * cols
        assert calls == want, (r, calls)


@pytest.mark.parametrize("mode", MODES)
def test_2d_bf16_matches_jax(port, mode):
    """A bf16 state on the (2, 2) mesh at g = 32 against JAX ``cg_solve_sharded_2d`` at
    bf16: both converge, iterations within ±1, Sum(x) and Norm2(x) within relative 1e-3 of
    JAX's x summed in f64 (the bars of tests/test_torch_bf16.py at g = 32)."""
    import jax.numpy as jnp

    res = port[(2, 2)][f"bf16 {mode}"]
    xj, sj = _jax_solve_2d((2, 2), 32, mode, dtype=jnp.bfloat16)
    assert res["converged"] and sj.converged and res["mode"] == mode
    assert res["x"].dtype == np.float32 and res["x"].shape == (32, 32)
    assert abs(res["iterations"] - sj.iterations) <= 1
    x = res["x"].astype(np.float64)
    print(f"bf16 {mode} on 2x2: iterations {res['iterations']} (JAX {sj.iterations}), "
          f"Sum(x) rel diff {abs(x.sum() - xj.sum()) / xj.sum():.2e}")
    np.testing.assert_allclose(x.sum(), xj.sum(), rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(xj), rtol=1e-3)

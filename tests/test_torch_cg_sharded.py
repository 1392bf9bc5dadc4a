"""The port's row-band sharded CG (tpusparse_torch.solvers.cg_sharded) against the JAX
package's, mirroring tests/test_cg_sharded.py and tests/test_sharded_mtx.py.

The port's ranks are gloo processes on the CPU (``dist.launch_local``; one rank runs in
this process); the JAX side runs on the conftest's virtual CPU devices, its Pallas kernels
in interpret mode.  f64 throughout, except the bf16-coefficient check.  Each rank count
runs every one of its solves in one group of ranks, once for the file (the ``port``
fixture); the tests read its results.  Bars:

- against JAX ``cg_solve_sharded`` on as many devices (``stencil5``, ``stencil5-const``
  recompute and classic, ``csr``, the padded grid g = 30): identical iterations, x to
  1e-12;
- across rank counts (g = 24) and against the port's single-device ``cg.cg_solve``:
  identical iterations, checksums and x to 1e-12 (bit for bit on one rank);
- ``__graft_entry__.dryrun_multichip``'s gate on 1, 2 and 4 ranks: g = 8n against the
  single-device solve, and g = 512 against the one-rank sharded solve, identical
  iterations, Sum/Norm2 to 1e-12;
- overlapped ≡ synchronous SpMV (y bit for bit) and solve, host-stepped ≡ fused with its
  four buckets > 0, plain-PyTorch updates ≡ the BLAS1 kernels' (both to 1e-12), bf16
  coefficients ≡ f32 bit for bit, the ``csr`` band on a stencil
  .mtx and on a banded non-stencil matrix, and the halo-reach refusal.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests and fixtures.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg_sharded

F64 = torch.float64
RANKS = (1, 2, 4)
SEED_X = 7


def _run_cases(device, cases):
    """Every case on this rank of the group; rank 0 returns {name: result}, a solve's or
    an SpMV's with every rank's ``HALO_CALLS`` of the case under "halo calls"."""
    out = {}
    for name, kind, kw in cases:
        cg_sharded.reset_halo_calls()
        out[name] = _run_case(device, g=kw["grid_size"], kind=kind, kw=dict(kw))
        if isinstance(out[name], dict):
            out[name]["halo calls"] = dist._all_objects(dict(cg_sharded.HALO_CALLS))
    return out


def _run_case(device, g, kind, kw):
    solve_kw = {k: kw.pop(k) for k in ("recompute_ap", "max_iters", "use_pallas_blas1")
                if k in kw}
    field = kw.pop("x", None)
    if kind in ("reach", "refuse"):
        make = (cg_sharded.make_sharded_operator if kind == "reach"
                else cg_sharded.cg_solve_sharded)
        try:
            make(device=device, **kw)
        except ValueError as e:
            return str(e)
        return None
    kw.setdefault("dtype", F64)
    op = cg_sharded.make_sharded_operator(device=device, **kw)
    if kind == "spmv":
        y, pap = op.local_spmv_dot(op.band_of(field))
        return {"y": dist.gather_to_host(y, rows=g), "pap": float(pap), "nnz": op.nnz}
    solve = (cg_sharded.cg_solve_sharded_stepped if kind == "stepped"
             else cg_sharded.cg_solve_sharded)
    x, s = solve(g, operator=op, **solve_kw)
    return {"x": dist.gather_to_host(x, rows=g), "iterations": s.iterations,
            "converged": s.converged, "mode": op.mode, "stats": s}


def _cases(n, mats):
    cases = [
        ("stencil5", "fused", dict(grid_size=16, mode="stencil5")),
        ("stencil5-const", "fused", dict(grid_size=16, mode="stencil5-const")),
        ("stencil5-const classic", "fused",
         dict(grid_size=16, mode="stencil5-const", recompute_ap=False)),
        ("csr", "fused", dict(grid_size=32, mode="csr")),
        ("csr's stencil5", "fused", dict(grid_size=32, mode="stencil5")),
        ("const g=24", "fused", dict(grid_size=24, mode="stencil5-const")),
        ("gate", "fused", dict(grid_size=8 * n, mode="stencil5", max_iters=200)),
        ("gate 512", "fused", dict(grid_size=512, mode="stencil5", max_iters=200)),
    ]
    if n == 2:
        return cases + BF16_CASES
    if n != 4:
        return cases
    x20 = np.random.RandomState(SEED_X).randn(20, 20)
    return cases + [
        ("pad stencil5", "fused", dict(grid_size=30, mode="stencil5")),
        ("pad stencil5-const", "fused", dict(grid_size=30, mode="stencil5-const")),
        ("pad csr", "fused", dict(grid_size=30, mode="csr")),
        ("overlap stencil5", "fused", dict(grid_size=24, mode="stencil5")),
        ("sync stencil5", "fused", dict(grid_size=24, mode="stencil5", overlap=False)),
        ("overlap stencil5-const", "fused",
         dict(grid_size=24, mode="stencil5-const", recompute_ap=False)),
        ("sync stencil5-const", "fused",
         dict(grid_size=24, mode="stencil5-const", recompute_ap=False, overlap=False)),
        ("spmv overlap stencil5", "spmv", dict(grid_size=20, mode="stencil5", x=x20)),
        ("spmv sync stencil5", "spmv",
         dict(grid_size=20, mode="stencil5", overlap=False, x=x20)),
        ("spmv overlap stencil5-const", "spmv",
         dict(grid_size=20, mode="stencil5-const", x=x20)),
        ("spmv sync stencil5-const", "spmv",
         dict(grid_size=20, mode="stencil5-const", overlap=False, x=x20)),
        ("stepped", "stepped", dict(grid_size=24, mode="stencil5")),
        ("plain blas1", "fused", dict(grid_size=24, mode="stencil5", use_pallas_blas1=False)),
        ("f32 stencil5", "fused", dict(grid_size=24, mode="stencil5", dtype=torch.float32)),
        ("f32 stencil5-bf16c", "fused",
         dict(grid_size=24, mode="stencil5-bf16c", dtype=torch.float32)),
        ("csr mtx", "fused", dict(grid_size=16, mode="csr", matrix=mats["mtx"])),
        ("spmv banded", "spmv", dict(grid_size=16, mode="csr", matrix=mats["banded"],
                                     x=mats["banded x"])),
        ("reach", "reach", dict(grid_size=8, mode="csr", matrix=mats["far"])),
    ]


# the bf16 state on 2 ranks (the classic loop), and the row bands' recompute loop refusing
# it
BF16_CASES = [
    ("bf16 stencil5", "fused", dict(grid_size=32, mode="stencil5", dtype=torch.bfloat16)),
    ("bf16 csr", "fused", dict(grid_size=32, mode="csr", dtype=torch.bfloat16)),
    ("bf16 stencil5-const", "refuse",
     dict(grid_size=32, mode="stencil5-const", dtype=torch.bfloat16)),
]


@pytest.fixture(scope="module")
def mats(tmp_path_factory):
    """The file and matrix operands: a stencil .mtx read by the port's reader, a banded
    non-stencil matrix within reach and one with columns anywhere (tests.fixtures), as
    the port's CSR."""
    from tests import fixtures
    from tests.test_torch_host import carry
    from tpusparse import generate as jgenerate
    from tpusparse_torch.cli.spmv_bench import load_operand

    path = tmp_path_factory.mktemp("sharded") / "g16.mtx"
    jgenerate.write_matrix_market_stencil5(str(path), 16)
    return {"mtx path": str(path), "mtx": load_operand(str(path))[0],
            "banded": carry(fixtures.banded(256, bandwidth=14, seed=5)),
            "banded x": np.random.RandomState(SEED_X).rand(16, 16),
            "far": carry(fixtures.random_sparse(64, density=0.2, seed=9))}


@pytest.fixture(scope="module")
def port(mats):
    """{ranks: {case: result}} for 1 (in this process), 2 and 4 gloo ranks."""
    out = {}
    for n in RANKS:
        cases = _cases(n, mats)
        out[n] = (_run_cases(torch.device("cpu"), cases) if n == 1
                  else dist.launch_local(_run_cases, n, cases, device="cpu"))
    return out


def _jax_solve(n, g, **kw):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    mesh = jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])
    kw.setdefault("dtype", jnp.float64)
    x, s = jcs.cg_solve_sharded(mesh, g, **kw)
    return np.asarray(x, np.float64), s


def _close(x, want, rtol=1e-12):
    np.testing.assert_allclose(x, want, rtol=rtol, atol=1e-14)


LOOPS = {"stencil5": {}, "stencil5-const": {},
         "stencil5-const classic": {"recompute_ap": False}}


@pytest.mark.parametrize("case", list(LOOPS))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_matches_jax(port, n, case):
    res = port[n][case]
    xj, sj = _jax_solve(n, 16, mode=case.split()[0], **LOOPS[case])
    assert res["converged"] and sj.converged
    assert res["iterations"] == sj.iterations
    _close(res["x"], xj)


@pytest.mark.parametrize("n", RANKS)
def test_csr_band_matches_jax_and_stencil5(port, n):
    res, st = port[n]["csr"], port[n]["csr's stencil5"]
    xj, sj = _jax_solve(n, 32, mode="csr")
    assert res["converged"] and res["iterations"] == sj.iterations == st["iterations"]
    _close(res["x"], xj)
    _close(res["x"], st["x"])


def test_recompute_matches_classic(port):
    a, b = port[4]["stencil5-const"], port[4]["stencil5-const classic"]
    assert a["converged"] and b["converged"] and a["iterations"] == b["iterations"]
    _close(a["x"], b["x"], rtol=1e-10)


def test_checksums_match_across_rank_counts(port):
    runs = [port[n]["const g=24"] for n in RANKS]  # cg_solve_sharded's default mode
    assert len({r["iterations"] for r in runs}) == 1
    assert {r["mode"] for r in runs} == {"stencil5-const"}
    sums = [r["x"].sum() for r in runs]
    norms = [np.linalg.norm(r["x"]) for r in runs]
    np.testing.assert_allclose(sums, sums[0], rtol=1e-12)
    np.testing.assert_allclose(norms, norms[0], rtol=1e-12)


def _single_device(g, max_iters=1000):
    from tpusparse_torch import formats, ops
    from tpusparse_torch.solvers import cg

    st = formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=F64, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True, config=cg.CGConfig(max_iters=max_iters))
    return x.numpy(), s


@pytest.mark.parametrize("n", RANKS)
def test_sharded_matches_single_device(port, n):
    res = port[n]["stencil5"]
    x1, s1 = _single_device(16)
    assert res["iterations"] == s1.iterations
    if n == 1:  # the same kernels (twins), the same dots: the same bits
        np.testing.assert_array_equal(res["x"], x1)
    _close(res["x"], x1)


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_multichip_gate(port, n):
    """``__graft_entry__.dryrun_multichip``'s checks: g = 8n (one 8-row band a rank)
    against the single-device solve, and g = 512 against the one-rank sharded solve."""
    small, x1, s1 = port[n]["gate"], *_single_device(8 * n, max_iters=200)
    large, one = port[n]["gate 512"], port[1]["gate 512"]
    for got, want, its in ((small, x1, s1.iterations), (large, one["x"], one["iterations"])):
        assert got["converged"] and got["iterations"] == its
        assert got["x"].shape == want.shape
        np.testing.assert_allclose(got["x"].sum(), want.sum(), rtol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(got["x"]), np.linalg.norm(want), rtol=1e-12)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const", "csr"])
def test_indivisible_grid_padded(port, mode):
    """g = 30 on 4 ranks: two zero pad rows on the last rank; stencil5-const falls back
    to stencil5, as in JAX, and ``op.mode`` says so."""
    import jax

    from tpusparse.solvers import cg_sharded as jcs

    res = port[4][f"pad {mode}"]
    xj, sj = _jax_solve(4, 30, mode=mode)
    jop = jcs.make_sharded_operator(jax.make_mesh((4,), ("x",), devices=jax.devices()[:4]),
                                    30, mode=mode)
    assert res["mode"] == jop.mode == ("stencil5" if mode == "stencil5-const" else mode)
    assert res["x"].shape == (30, 30)
    assert res["converged"] and res["iterations"] == sj.iterations
    _close(res["x"], xj)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const"])
def test_overlap_matches_synchronous(port, mode):
    a, b = port[4][f"overlap {mode}"], port[4][f"sync {mode}"]
    assert a["iterations"] == b["iterations"]
    _close(a["x"], b["x"])
    ya, yb = port[4][f"spmv overlap {mode}"], port[4][f"spmv sync {mode}"]
    np.testing.assert_array_equal(ya["y"], yb["y"])  # every row: the same kernel arithmetic
    np.testing.assert_allclose(ya["pap"], yb["pap"], rtol=1e-14)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const"])
def test_overlapped_spmv_against_dense(port, mode):
    from tpusparse import formats as jformats
    from tpusparse import generate as jgenerate

    dense = jformats.stencil5_to_csr(jgenerate.make_stencil5(20)).to_dense()
    x = np.random.RandomState(SEED_X).randn(20, 20)
    y_ref = (dense @ x.ravel()).reshape(20, 20)
    got = port[4][f"spmv overlap {mode}"]
    np.testing.assert_allclose(got["y"], y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["pap"], float(x.ravel() @ y_ref.ravel()), rtol=1e-12)


def test_stepped_matches_fused(port):
    fused, stepped = port[4]["overlap stencil5"], port[4]["stepped"]
    assert stepped["iterations"] == fused["iterations"]
    _close(stepped["x"], fused["x"])
    s = stepped["stats"]
    assert min(s.halo_time_ms, s.spmv_time_ms, s.allreduce_time_ms, s.blas1_time_ms) > 0
    assert s.reduction_time_ms == s.allreduce_time_ms
    assert s.halo_time_ms + s.spmv_time_ms + s.allreduce_time_ms + s.blas1_time_ms \
        <= s.total_time_ms


HALO_KERNELS = {"stencil5": ("spmv_stencil5",),
                "stencil5-const": ("spmv_stencil5_const_pupdate_dot",
                                   "cg_const_update_recompute"),
                "stencil5-const classic": ("spmv_stencil5_const",),
                "csr": ("spmv_ell",),
                "stepped": ("spmv_stencil5",)}
# cases whose bands (of 3 rows or more) the SpMV takes in three pieces: a rank between two
# others hands exchanged rows to two of them, its first and its last row's
PIECES = ("stencil5", "stencil5-const classic", "stepped")


@pytest.mark.parametrize("n,case", [(n, c) for n in RANKS for c in HALO_KERNELS
                                    if c != "stepped"] + [(4, "stepped")])
def test_kernels_read_exchanged_halo_rows(port, n, case):
    """Every rank with a neighbour exchanged rows once an iteration and handed them to its
    path's kernels; one rank exchanges nothing and counts nothing."""
    res, kernels = port[n][case], HALO_KERNELS[case]
    for r, calls in enumerate(res["halo calls"]):
        want = dict.fromkeys(cg_sharded.HALO_CALLS, 0)
        if n > 1:
            want["exchange"] = res["iterations"]
            per = 2 if case in PIECES and 0 < r < n - 1 else 1
            want.update({k: per * res["iterations"] for k in kernels})
        assert calls == want, (r, calls)


def test_plain_blas1_matches_the_kernels(port):
    """``use_pallas_blas1=False``: the classic loop's updates as plain PyTorch ops."""
    a, b = port[4]["plain blas1"], port[4]["overlap stencil5"]
    assert a["iterations"] == b["iterations"]
    _close(a["x"], b["x"])


def test_bf16_coefficients_match_f32(port):
    a, b = port[4]["f32 stencil5"], port[4]["f32 stencil5-bf16c"]
    assert a["x"].dtype == np.float32 and a["iterations"] == b["iterations"]
    np.testing.assert_array_equal(a["x"], b["x"])


def test_csr_band_on_a_stencil_mtx(port, mats):
    """The file through the csr band on 4 ranks, against JAX's sharded csr on the same
    file and the port's stencil5 solve of the same grid."""
    from tpusparse import formats as jformats
    from tpusparse import io_mtx as jio

    res = port[4]["csr mtx"]
    jcsr = jformats.coo_to_csr(jio.load_matrix_market(mats["mtx path"]))
    xj, sj = _jax_solve(4, 16, mode="csr", matrix=jcsr)
    assert res["converged"] and res["iterations"] == sj.iterations \
        == port[4]["stencil5"]["iterations"]
    _close(res["x"], xj)
    _close(res["x"], port[4]["stencil5"]["x"])


def test_csr_band_on_a_banded_matrix(port, mats):
    from tests import fixtures

    csr = fixtures.banded(256, bandwidth=14, seed=5)
    x = mats["banded x"]
    y_ref = csr.to_dense() @ x.ravel()
    got = port[4]["spmv banded"]
    np.testing.assert_allclose(got["y"].ravel(), y_ref, rtol=1e-12)
    np.testing.assert_allclose(got["pap"], float(x.ravel() @ y_ref), rtol=1e-12)
    assert got["nnz"] == csr.nnz  # the matrix's own, not the stencil formula


def test_csr_band_refuses_a_reach_violation(port):
    import jax
    import jax.numpy as jnp

    from tests import fixtures
    from tpusparse.solvers import cg_sharded as jcs

    assert "halo reach" in port[4]["reach"]
    with pytest.raises(ValueError, match="halo reach"):
        jcs.make_sharded_operator(jax.make_mesh((4,), ("x",), devices=jax.devices()[:4]), 8,
                                  mode="csr", matrix=fixtures.random_sparse(64, 0.2, 9),
                                  dtype=jnp.float64)


def test_overlap_timing_script_runs_both_spmvs(tmp_path):
    """``bench.sharded_overlap`` on the CPU: both operators, the same iterations and x."""
    import json

    from tpusparse_torch.bench import sharded_overlap

    out = tmp_path / "overlap.json"
    assert sharded_overlap.main(["--grid=24", "--ranks=2", "--modes=stencil5", "--reps=1",
                                 "--platform=cpu", f"--json={out}"]) == 0
    (row,) = json.loads(out.read_text())
    assert row["ranks"] == 2 and len(row["overlap"]) == len(row["sync"]) == 2
    assert row["iterations"][0] == row["iterations"][1] and row["rel_diff"] <= 1e-12


def test_refusals_without_a_group():
    with pytest.raises(ValueError, match="supports"):
        cg_sharded.make_sharded_operator(8, mode="dia", device="cpu")
    with pytest.raises(ValueError, match="recompute_ap"):
        cg_sharded.cg_solve_sharded(8, mode="stencil5", recompute_ap=True, device="cpu")
    op = cg_sharded.make_sharded_operator(8, mode="stencil5", device="cpu")
    assert cg_sharded.make_sharded_operator(8, mode="stencil5", device="cpu") is op
    cg_sharded.clear_caches()
    assert cg_sharded.make_sharded_operator(8, mode="stencil5", device="cpu") is not op
    cg_sharded.clear_caches()


@pytest.mark.parametrize("mode", ["stencil5", "csr"])
def test_sharded_bf16_matches_jax(port, mode):
    """A bf16 state on 2 ranks against JAX ``cg_solve_sharded`` at bf16 on 2 devices:
    both converge, iterations within ±1, Sum(x) and Norm2(x) within relative 1e-3 of JAX's
    x summed in f64 (the bars of tests/test_torch_bf16.py at g = 32); the same x as the
    port's single-device bf16 solve of the mode to 1e-3."""
    import jax.numpy as jnp

    from tpusparse_torch import formats, ops
    from tpusparse_torch.solvers import cg

    res = port[2][f"bf16 {mode}"]
    xj, sj = _jax_solve(2, 32, mode=mode, dtype=jnp.bfloat16)
    assert res["converged"] and sj.converged and res["x"].dtype == np.float32
    assert abs(res["iterations"] - sj.iterations) <= 1
    x = res["x"].astype(np.float64)
    print(f"bf16 {mode} on 2 ranks: iterations {res['iterations']} (JAX {sj.iterations}), "
          f"Sum(x) rel diff {abs(x.sum() - xj.sum()) / xj.sum():.2e}")
    np.testing.assert_allclose(x.sum(), xj.sum(), rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(xj), rtol=1e-3)
    st = formats.Stencil5(grid_size=32, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator(mode, st, dtype=torch.bfloat16, device="cpu")
    x1, s1 = cg.cg_solve(op, b_is_ones=True)
    assert abs(res["iterations"] - s1.iterations) <= 1
    np.testing.assert_allclose(x.sum(), op.from_field(x1).double().sum().item(), rtol=1e-3)


def test_sharded_recompute_refuses_bf16(port):
    """The row bands' recompute loop (``stencil5-const``'s default) raises ValueError at
    bf16, where JAX's raises TypeError."""
    import jax.numpy as jnp

    assert "bf16" in port[2]["bf16 stencil5-const"]
    with pytest.raises(TypeError, match="carry"):
        _jax_solve(2, 32, mode="stencil5-const", dtype=jnp.bfloat16)

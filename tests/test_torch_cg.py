"""The port's CG solver (tpusparse_torch.solvers.cg) against the JAX package's solver and
the numpy transcription of the reference algorithm (tests.test_cg.reference_cg).

f64 on the CPU: the port's operators run their plain twins, the JAX solver runs its
Pallas kernels in interpret mode.  Iteration counts must be identical; solutions agree to
rtol 1e-10 (the bar of tests/test_kernels_stencil5.py's recompute-vs-classic parity).
``stencil5-bf16c`` runs in f32, its native state: iteration counts identical, x to rtol
1e-5, and bit for bit equal to ``stencil5`` in f32.  The generic operators ``csr``,
``dia`` and ``bcoo`` run the classic loop, f64: iteration counts identical to the JAX
solver with the same mode, x to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_cg import reference_cg
from tests.test_kernels_gather import _random_banded_csr
from tests.test_torch_host import carry
from tpusparse import formats, generate
from tpusparse import ops as jops
from tpusparse.kernels import stencil5 as jst5
from tpusparse.solvers import cg as jcg
from tpusparse_torch import convert, ops
from tpusparse_torch.solvers import cg

LOOPS = {"recompute": True, "classic": False}


def _stencil(g):
    return formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))


def _port_op(g, mode="stencil5-const"):
    return ops.get_operator(mode, carry(_stencil(g)), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("g", [8, 16, 33])
@pytest.mark.parametrize("mode,loop", [("stencil5-const", "recompute"),
                                       ("stencil5-const", "classic"),
                                       ("stencil5-const-xla", "classic")])
def test_cg_matches_jax_and_reference(g, mode, loop):
    A = formats.stencil5_to_csr(generate.make_stencil5(g)).to_dense()
    x_ref, iters_ref, _ = reference_cg(A, np.ones(g * g))

    jop = jops.get_operator(mode, _stencil(g), dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jnp.float64),
                          recompute_ap=LOOPS[loop] if mode == "stencil5-const" else None)
    op = _port_op(g, mode)
    x, s = cg.cg_solve(op, b_is_ones=True, recompute_ap=LOOPS[loop])

    assert s.converged and sj.converged
    assert s.iterations == sj.iterations == iters_ref, (s.iterations, sj.iterations, iters_ref)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(op.from_field(x).numpy(), x_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(s.relative_residual, sj.relative_residual, rtol=1e-6,
                               atol=1e-14)


@pytest.mark.parametrize("loop", ["recompute", "classic"])
def test_cg_nonzero_x0_matches_jax(loop):
    g = 12
    x0 = np.random.RandomState(0).randn(g, g)
    jop = jops.get_operator("stencil5-const", _stencil(g), dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jnp.float64), jnp.asarray(x0),
                          recompute_ap=LOOPS[loop])
    op = _port_op(g)
    x, s = cg.cg_solve(op, op.ones_b(), convert.fields_from_numpy(x0, "cpu"),
                       recompute_ap=LOOPS[loop])
    assert s.converged and s.iterations == sj.iterations
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    A = formats.stencil5_to_csr(generate.make_stencil5(g)).to_dense()
    assert np.linalg.norm(np.ones(g * g) - A @ x.numpy().ravel()) / g < 1e-5


@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("mode", ["stencil5", "stencil5-bf16c", "stencil5-xla"])
@pytest.mark.parametrize("blas1", [True, False])
def test_cg_values_carrying_matches_jax_and_reference(g, mode, blas1):
    """The classic loop with planes (K8's twin), with the BLAS1 twins of K4-K6 or with
    plain updates, against the JAX solver with the same ``use_pallas_blas1``."""
    f32 = mode == "stencil5-bf16c"
    A = formats.stencil5_to_csr(generate.make_stencil5(g)).to_dense()
    x_ref, iters_ref, _ = reference_cg(A, np.ones(g * g))
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64, torch.float64)
    jop = jops.get_operator(mode, _stencil(g), dtype=jdt)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jdt), use_pallas_blas1=blas1)
    op = ops.get_operator(mode, carry(_stencil(g)), dtype=tdt, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True, use_pallas_blas1=blas1)
    assert x.dtype == tdt and s.converged and sj.converged
    assert s.iterations == sj.iterations == iters_ref, (s.iterations, sj.iterations, iters_ref)
    rtol, atol = (1e-5, 1e-6) if f32 else (1e-10, 1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=rtol, atol=atol)
    np.testing.assert_allclose(op.from_field(x).numpy(), x_ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("blas1", [True, False])
def test_bf16c_solution_equals_stencil5_f32_bitwise(blas1):
    """tests/test_cg.py's property, for the port: bf16 planes holding 5/−1/0 give the f32
    planes' solution bit for bit."""
    g = 24
    x32, s32 = cg.cg_solve(ops.get_operator("stencil5", carry(_stencil(g)), device="cpu"),
                           b_is_ones=True, use_pallas_blas1=blas1)
    x16, s16 = cg.cg_solve(ops.get_operator("stencil5-bf16c", carry(_stencil(g)),
                                            device="cpu"),
                           b_is_ones=True, use_pallas_blas1=blas1)
    assert s16.iterations == s32.iterations and s32.converged
    assert torch.equal(x16, x32)


@pytest.mark.parametrize("mode,loop", [("stencil5-const", "recompute"),
                                       ("stencil5-const", "classic"),
                                       ("stencil5", "classic")])
def test_cg_nonzero_x0_through_axpby_dot(mode, loop):
    """r0 = b − A·x0 with <r0, r0> through K7's twin, <b, b> through K6's."""
    g = 12
    x0 = np.random.RandomState(1).randn(g, g)
    jop = jops.get_operator(mode, _stencil(g), dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jnp.float64), jnp.asarray(x0),
                          use_pallas_blas1=True,
                          recompute_ap=LOOPS[loop] if mode == "stencil5-const" else None)
    op = _port_op(g, mode)
    x, s = cg.cg_solve(op, op.ones_b(), convert.fields_from_numpy(x0, "cpu"),
                       recompute_ap=LOOPS[loop], use_pallas_blas1=True)
    assert s.converged and s.iterations == sj.iterations
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    x_plain, s_plain = cg.cg_solve(op, op.ones_b(), convert.fields_from_numpy(x0, "cpu"),
                                   recompute_ap=LOOPS[loop], use_pallas_blas1=False)
    assert s_plain.iterations == s.iterations and torch.equal(x_plain, x)


def test_explicit_b_matches_synthesized_ones():
    op = _port_op(16)
    x1, s1 = cg.cg_solve(op, b_is_ones=True)
    b = op.ones_b()
    x2, s2 = cg.cg_solve(op, b)
    assert s1.iterations == s2.iterations
    assert torch.equal(x1, x2)
    assert torch.equal(b, torch.ones_like(b))  # the solve never writes into b


def test_recompute_step_from_shared_mid_solve_state():
    """One recompute-Ap iteration (pass A then pass B) from the same mid-solve state in
    both packages: a few classic iterations in numpy, carried across with convert.py."""
    g = 24
    A = formats.stencil5_to_csr(generate.make_stencil5(g)).to_dense()
    x, r = np.zeros(g * g), np.ones(g * g)
    p, rr_prev, rr = np.zeros(g * g), 1.0, float(r @ r)
    for k in range(3):
        p = r + (0.0 if k == 0 else rr / rr_prev) * p
        alpha = rr / float(p @ (A @ p))
        x, r = x + alpha * p, r - alpha * (A @ p)
        rr_prev, rr = rr, float(r @ r)
    beta = rr / rr_prev
    state = {"x": x.reshape(g, g), "r": r.reshape(g, g), "p": p.reshape(g, g)}

    jkw = {"diag": 5.0, "offdiag": -1.0, "block_rows": 8, "interpret": True}
    pj, papj = jst5.spmv_stencil5_const_pupdate_dot_pipelined(beta, state["r"], state["p"],
                                                              **jkw)
    xj, rj, rrj = jst5.cg_const_update_recompute_pipelined(
        float(rr / papj), state["x"], state["r"], pj, **jkw)
    pj, papj, xj, rj, rrj = (np.asarray(a) for a in (pj, papj, xj, rj, rrj))

    op = _port_op(g)
    t = convert.fields_from_numpy(state, "cpu", torch.float64)
    assert not np.shares_memory(t["x"].numpy(), state["x"])
    pt, pap = op.run_pupdate_dot_op(torch.tensor(beta, dtype=torch.float64), t["r"], t["p"],
                                    out=torch.empty_like(t["p"]))
    xt, rt, rrt = op.run_update_recompute_op(rr / pap, t["x"], t["r"], pt)
    for got, want in ((pt, pj), (pap, papj), (xt, xj), (rt, rj), (rrt, rrj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_zero_rhs_runs_no_iteration():
    op = _port_op(12)
    x, s = cg.cg_solve(op, torch.zeros(12, 12, dtype=torch.float64))
    assert s.iterations == 0 and s.converged
    assert float(x.abs().max()) == 0.0


@pytest.mark.parametrize("loop", ["recompute", "classic"])
def test_max_iters_cap(loop):
    x, s = cg.cg_solve(_port_op(10), b_is_ones=True, config=cg.CGConfig(max_iters=3),
                       recompute_ap=LOOPS[loop])
    assert s.iterations == 3 and not s.converged


def test_unported_options_raise():
    """The options a solve refuses, as the JAX solver refuses them: the fused loop on an
    operator without a fused pass (ValueError, also in the JAX package), the fused loop
    together with the recompute loop, the recompute loop without its passes."""
    op = _port_op(8)
    for mode in ("stencil5-xla", "stencil5-const-xla", "csr", "dia"):
        with pytest.raises(ValueError, match="run_fused_pupdate_op"):
            cg.cg_solve(_port_op(8, mode), b_is_ones=True, fused_pupdate=True)
    with pytest.raises(ValueError, match="fused_pupdate requested"):
        jcg.cg_solve(jops.get_operator("stencil5-xla", _stencil(8), dtype=jnp.float64),
                     jnp.ones((8, 8), jnp.float64), fused_pupdate=True)
    with pytest.raises(ValueError, match="exclude each other"):
        cg.cg_solve(op, b_is_ones=True, fused_pupdate=True, recompute_ap=True)
    with pytest.raises(ValueError, match="recompute_ap"):
        cg.cg_solve(_port_op(8, "stencil5-const-xla"), b_is_ones=True, recompute_ap=True)
    with pytest.raises(ValueError, match="b_is_ones"):
        cg.cg_solve(op, x0=op.ones_b(), b_is_ones=True)
    with pytest.raises(ValueError, match="recompute_ap"):
        cg.cg_solve(_port_op(8, "csr"), b_is_ones=True, recompute_ap=True)
    assert ops.available_modes() == jops.available_modes()


def test_operand_from_planes_and_csr():
    st = generate.make_stencil5(9, 4.0, -0.5)
    assert convert.operand_from_stencil5(formats.Stencil5(9, st.planes)) == (4.0, -0.5)
    op = ops.get_operator("stencil5-const", carry(formats.stencil5_to_csr(st)), device="cpu")
    y = op.run_device(op.ones_b())
    np.testing.assert_allclose(op.from_field(y).numpy(),
                               formats.stencil5_to_csr(st).to_dense() @ np.ones(81), rtol=1e-6)
    planes = st.planes.copy()
    planes[formats.C, 3, 3] = 7.0
    with pytest.raises(ValueError, match="use mode 'stencil5'"):
        convert.operand_from_stencil5(formats.Stencil5(9, planes))
    op = ops.get_operator("stencil5", carry(formats.Stencil5(9, planes)), device="cpu")
    assert op.planes[formats.C, 3, 3] == 7.0


def _spd_banded(n=300, seed=3):
    """A symmetric, diagonally dominant matrix with random entries in a band of 20
    (symmetrized tests/test_kernels_gather.py generator): SPD, and not a stencil."""
    d = _random_banded_csr(n, 20, 4, seed=seed).to_dense()
    a = (d + d.T) / 2
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    r, c = np.nonzero(a)
    return formats.coo_to_csr(formats.COOMatrix(n, n, r.astype(np.int64), c.astype(np.int64),
                                                a[r, c]))


@pytest.mark.parametrize("mode", ["csr", "dia", "bcoo"])
@pytest.mark.parametrize("matrix", ["stencil_16", "spd_banded"])
def test_cg_generic_matches_jax(matrix, mode):
    """The classic loop over the generic operators (the ELL and DIA twins, the sparse CSR
    matvec) against the JAX solver over the same mode: the g = 16 stencil in its
    planes-free form (the port makes its operands on the device) and an SPD banded
    CSR."""
    mat = _stencil(16) if matrix == "stencil_16" else _spd_banded()
    n = mat.num_rows
    jop = jops.get_operator(mode, mat, dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jop.as_field(np.ones(n)).astype(jnp.float64))
    op = ops.get_operator(mode, carry(mat), dtype=torch.float64, device="cpu")
    assert not cg.uses_recompute(op)
    x, s = cg.cg_solve(op, b_is_ones=True)
    assert s.converged and sj.converged
    assert s.iterations == sj.iterations, (s.iterations, sj.iterations)
    np.testing.assert_allclose(op.from_field(x).numpy(), np.asarray(jop.from_field(xj)),
                               rtol=1e-10, atol=1e-12)


def test_cg_on_a_matrix_without_a_grid():
    """b = ones has num_cols elements, also for a .mtx-like CSR that is no g×g stencil
    (grid_size 0): ones_b used to build a (grid_size, grid_size) field."""
    csr = fixtures.tridiagonal(300)
    assert csr.grid_size == 0
    op = ops.get_operator("csr", carry(csr), dtype=torch.float64, device="cpu")
    b = op.ones_b()
    assert b.shape == (300,) and torch.equal(b, torch.ones(300, dtype=torch.float64))
    x, s = cg.cg_solve(op, b_is_ones=True, config=cg.CGConfig(max_iters=400))
    assert s.converged
    np.testing.assert_allclose(csr.to_dense() @ x.numpy(), np.ones(300), atol=1e-5)


FUSED_MODES = ["stencil5-const", "stencil5", "stencil5-bf16c"]


@pytest.mark.parametrize("g", [8, 16, 33])
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("blas1", [True, False])
def test_fused_cg_matches_jax_fused_and_unfused(g, mode, blas1):
    """The fused p-update loop (K10's twin on stencil5-const, K9's on stencil5 and
    stencil5-bf16c, then K4's twin or the plain update) against the JAX solver's fused
    loop and the port's own default loop: the same iteration counts, x to 1e-10 in f64
    (1e-5 for stencil5-bf16c, in f32)."""
    f32 = mode == "stencil5-bf16c"
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64, torch.float64)
    jop = jops.get_operator(mode, _stencil(g), dtype=jdt)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jdt), fused_pupdate=True)
    op = ops.get_operator(mode, carry(_stencil(g)), dtype=tdt, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True, fused_pupdate=True, use_pallas_blas1=blas1)
    x_u, s_u = cg.cg_solve(op, b_is_ones=True, use_pallas_blas1=blas1)
    assert x.dtype == tdt and s.converged and sj.converged
    assert s.iterations == sj.iterations == s_u.iterations, (s.iterations, sj.iterations,
                                                             s_u.iterations)
    rtol, atol = (1e-5, 1e-6) if f32 else (1e-10, 1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=rtol, atol=atol)
    np.testing.assert_allclose(x.numpy(), x_u.numpy(), rtol=rtol, atol=atol)


def test_fused_cg_bf16c_equals_stencil5_f32_and_counts_nothing_on_the_cpu():
    """bf16 planes holding 5/−1/0 give the f32 planes' fused solution bit for bit; on CPU
    tensors the wrappers run their twins, so no launch is counted."""
    from tpusparse_torch.kernels import blas1, stencil5 as st5

    st5.reset_launches()
    blas1.reset_launches()
    g = 24
    x32, s32 = cg.cg_solve(ops.get_operator("stencil5", carry(_stencil(g)), device="cpu"),
                           b_is_ones=True, fused_pupdate=True)
    x16, s16 = cg.cg_solve(ops.get_operator("stencil5-bf16c", carry(_stencil(g)),
                                            device="cpu"), b_is_ones=True, fused_pupdate=True)
    assert s32.converged and s16.iterations == s32.iterations and torch.equal(x16, x32)
    assert st5.LAUNCHES == dict.fromkeys(st5.LAUNCHES, 0)
    assert blas1.LAUNCHES == dict.fromkeys(blas1.LAUNCHES, 0)


@pytest.mark.parametrize("mode", ["stencil5-const", "stencil5"])
def test_fused_cg_nonzero_x0_matches_jax(mode):
    """r0 = b − A·x0 (K7's twin) then the fused loop, against the JAX fused solve."""
    g = 12
    x0 = np.random.RandomState(2).randn(g, g)
    jop = jops.get_operator(mode, _stencil(g), dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jnp.ones((g, g), jnp.float64), jnp.asarray(x0),
                          fused_pupdate=True)
    op = _port_op(g, mode)
    x, s = cg.cg_solve(op, op.ones_b(), convert.fields_from_numpy(x0, "cpu"),
                       fused_pupdate=True)
    assert s.converged and s.iterations == sj.iterations
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", jops.available_modes())
def test_fused_pass_exists_where_jax_has_it(mode):
    """run_fused_pupdate_op on the modes whose JAX operator has one and on no other; with
    β = 0 and p = 0 it gives (r, A·r, <r, A·r>); free() drops it."""
    jop = jops.get_operator(mode, _stencil(8), dtype=jnp.float64)
    op = _port_op(8, mode)
    has = getattr(jop, "run_fused_pupdate_op", None) is not None
    assert (op.run_fused_pupdate_op is not None) == has == (op.name in FUSED_MODES)
    if has:
        r = op.ones_b()
        p, ap, pap = op.run_fused_pupdate_op(0.0, r, torch.zeros_like(r))
        assert torch.equal(p, r) and torch.equal(ap, op.run_device(r))
        assert float(pap) == pytest.approx(float((r * ap).sum()), rel=1e-14)
    op.free()
    assert op.run_fused_pupdate_op is None


STEPPED_MODES = ["stencil5", "stencil5-const", "csr", "dia"]


@pytest.mark.parametrize("g", [8, 16, 33])
@pytest.mark.parametrize("mode", STEPPED_MODES)
@pytest.mark.parametrize("blas1", [True, False])
def test_stepped_cg_matches_jax_stepped(g, mode, blas1):
    """The host-stepped classic loop (the SpMV's twin with its dot, then K4's and K5's
    twins, or plain updates) against the JAX package's cg_solve_stepped in interpret mode,
    f64: equal iteration counts, x to 1e-12, and all three phase buckets filled."""
    jop = jops.get_operator(mode, _stencil(g), dtype=jnp.float64)
    b = jop.as_field(np.ones(g * g)).astype(jnp.float64)
    xj, sj = jcg.cg_solve_stepped(jop.run_device_dot, b, use_pallas_blas1=blas1)
    op = ops.get_operator(mode, carry(_stencil(g)), dtype=torch.float64, device="cpu")
    x, s = cg.cg_solve_stepped(op.run_device_dot, op.ones_b(), use_pallas_blas1=blas1)
    assert s.converged and sj.converged
    assert s.iterations == sj.iterations, (s.iterations, sj.iterations)
    np.testing.assert_allclose(op.from_field(x).numpy(), np.asarray(jop.from_field(xj)),
                               rtol=1e-12, atol=1e-12)
    assert s.spmv_time_ms > 0 and s.blas1_time_ms > 0 and s.reduction_time_ms > 0
    assert s.spmv_time_ms + s.blas1_time_ms + s.reduction_time_ms <= s.total_time_ms


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const", "csr", "bcoo"])
def test_stepped_cg_matches_own_classic_solve(mode):
    """The stepped loop and cg_solve's classic loop run the same arithmetic (α and β
    divided on the host in f64 round as on the device): equal iterations, x to 1e-12."""
    op = _port_op(24, mode)
    x_ref, s_ref = cg.cg_solve(op, b_is_ones=True, recompute_ap=False)
    b = op.ones_b()
    x, s = cg.cg_solve_stepped(op.run_device_dot, b)
    assert s.converged and s.iterations == s_ref.iterations
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(b, torch.ones_like(b))  # the solve never writes into b


@pytest.mark.parametrize("blas1", [True, False])
def test_stepped_cg_nonzero_x0_matches_jax(blas1):
    """r0 = b − A·x0 (K7's twin, or the plain difference), ‖b‖ from <b, b>."""
    g = 12
    x0 = np.random.RandomState(3).randn(g, g)
    jop = jops.get_operator("stencil5", _stencil(g), dtype=jnp.float64)
    xj, sj = jcg.cg_solve_stepped(jop.run_device_dot, jnp.ones((g, g), jnp.float64),
                                  jnp.asarray(x0), spmv=jop.run_device,
                                  use_pallas_blas1=blas1)
    op = _port_op(g, "stencil5")
    x, s = cg.cg_solve_stepped(op.run_device_dot, op.ones_b(),
                               convert.fields_from_numpy(x0, "cpu"), spmv=op.run_device,
                               use_pallas_blas1=blas1)
    assert s.converged and s.iterations == sj.iterations
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s.relative_residual, sj.relative_residual, rtol=1e-6)
    with pytest.raises(ValueError, match="spmv"):
        cg.cg_solve_stepped(op.run_device_dot, op.ones_b(), op.ones_b())


def test_stepped_cg_zero_rhs_and_max_iters():
    op = _port_op(10, "stencil5")
    x, s = cg.cg_solve_stepped(op.run_device_dot, torch.zeros(10, 10, dtype=torch.float64))
    assert s.iterations == 0 and s.converged and float(x.abs().max()) == 0.0
    assert s.spmv_time_ms == s.blas1_time_ms == s.reduction_time_ms == 0.0
    x, s = cg.cg_solve_stepped(op.run_device_dot, op.ones_b(),
                               config=cg.CGConfig(max_iters=3))
    assert s.iterations == 3 and not s.converged
    _, s_ref = cg.cg_solve(op, b_is_ones=True, config=cg.CGConfig(max_iters=3))
    assert s.residual_norm == pytest.approx(s_ref.residual_norm, rel=1e-12)

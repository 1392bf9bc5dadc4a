"""The port's CG solver (tpusparse_torch.solvers.cg) against the JAX package's solver and
the numpy transcription of the reference algorithm (tests.test_cg.reference_cg).

f64 on the CPU: the port's operators run their plain twins, the JAX solver runs its
Pallas kernels in interpret mode.  Iteration counts must be identical; solutions agree to
rtol 1e-10 (the bar of tests/test_kernels_stencil5.py's recompute-vs-classic parity).
``stencil5-bf16c`` runs in f32, its native state: iteration counts identical, x to rtol
1e-5, and bit for bit equal to ``stencil5`` in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cg import reference_cg
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
    return ops.get_operator(mode, _stencil(g), dtype=torch.float64, device="cpu")


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
    op = ops.get_operator(mode, _stencil(g), dtype=tdt, device="cpu")
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
    x32, s32 = cg.cg_solve(ops.get_operator("stencil5", _stencil(g), device="cpu"),
                           b_is_ones=True, use_pallas_blas1=blas1)
    x16, s16 = cg.cg_solve(ops.get_operator("stencil5-bf16c", _stencil(g), device="cpu"),
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
    op = _port_op(8)
    with pytest.raises(NotImplementedError, match="K9/K10"):
        cg.cg_solve(op, b_is_ones=True, fused_pupdate=True)
    with pytest.raises(ValueError, match="recompute_ap"):
        cg.cg_solve(_port_op(8, "stencil5-const-xla"), b_is_ones=True, recompute_ap=True)
    with pytest.raises(ValueError, match="b_is_ones"):
        cg.cg_solve(op, x0=op.ones_b(), b_is_ones=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ops.get_operator("csr", _stencil(8), device="cpu")


def test_operand_from_planes_and_csr():
    st = generate.make_stencil5(9, 4.0, -0.5)
    assert convert.operand_from_stencil5(formats.Stencil5(9, st.planes)) == (4.0, -0.5)
    op = ops.get_operator("stencil5-const", formats.stencil5_to_csr(st), device="cpu")
    y = op.run_device(op.ones_b())
    np.testing.assert_allclose(op.from_field(y).numpy(),
                               formats.stencil5_to_csr(st).to_dense() @ np.ones(81), rtol=1e-6)
    planes = st.planes.copy()
    planes[formats.C, 3, 3] = 7.0
    with pytest.raises(ValueError, match="use mode 'stencil5'"):
        convert.operand_from_stencil5(formats.Stencil5(9, planes))
    op = ops.get_operator("stencil5", formats.Stencil5(9, planes), device="cpu")
    assert op.planes[formats.C, 3, 3] == 7.0

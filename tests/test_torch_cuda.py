"""The port's CUDA kernels on a card, against their plain PyTorch twins.

Every test here is marked ``cuda`` and skips without a card.  The file imports no JAX, so
it also runs where JAX is not installed; tests/conftest.py does import JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider

Tolerances, relative to the largest reference magnitude: f64 1e-12; f32 1e-5 for fields
and 1e-4 for dots (the dots sum in another order).  CG: equal iteration counts, x to rtol
1e-10.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats import Stencil5
from tpusparse_torch import ops
from tpusparse_torch.kernels import stencil5 as st5
from tpusparse_torch.solvers import cg

KW = {"diag": 5.0, "offdiag": -1.0}
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _randn(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_twins_on_card(dev, g, dtype):
    tol_field, tol_dot = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(g)
    x, r, p = (_randn(gen, dev, dtype, g, g) for _ in range(3))
    hp, hn = (_randn(gen, dev, dtype, 1, g) for _ in range(2))
    s = torch.tensor(0.7, dtype=dtype, device=dev)

    y, d = st5.spmv_stencil5_const(x, hp, hn, with_dot=True, **KW)
    yp, dp = st5.spmv_stencil5_const_plain(x, hp, hn, with_dot=True, **KW)
    assert _rel(y, yp) <= tol_field and _rel(d, dp) <= tol_dot
    assert _rel(st5.spmv_stencil5_const(x, **KW), st5.spmv_stencil5_const_plain(x, **KW)) \
        <= tol_field
    for beta, halos in ((torch.zeros_like(s), (None, None)), (s, (hp, hn))):
        p0 = p.clone()
        pn, d = st5.spmv_stencil5_const_pupdate_dot(beta, r, p, *halos, **KW)
        pnp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(beta, r, p, *halos, **KW)
        assert torch.equal(p, p0)  # p' went to a new buffer
        assert _rel(pn, pnp) <= tol_field and _rel(d, dp) <= tol_dot
    xk, rk, d = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p, hp, hn, **KW)
    xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p, hp, hn, **KW)
    assert _rel(xk, xp) <= tol_field and _rel(rk, rp) <= tol_field and _rel(d, dp) <= tol_dot


def test_each_wrapper_counts_its_launches(dev):
    g = 64
    x, r, p = (torch.rand(g, g, device=dev, dtype=torch.float64) for _ in range(3))
    a = torch.tensor(0.5, dtype=torch.float64, device=dev)
    st5.reset_launches()
    st5.spmv_stencil5_const(x, **KW)
    st5.spmv_stencil5_const(x, with_dot=True, **KW)
    st5.spmv_stencil5_const_pupdate_dot(a, r, p, **KW)
    st5.cg_const_update_recompute(a, x, r, p, **KW)
    st5.spmv_stencil5_const_plain(x, **KW)  # twins do not count
    st5.cg_const_update_recompute_plain(a, x, r, p, **KW)
    assert st5.LAUNCHES == {"spmv_stencil5_const": 2, "spmv_stencil5_const_pupdate_dot": 1,
                            "cg_const_update_recompute": 1}


def test_kernel_path_rejects_what_it_cannot_run(dev):
    x = torch.rand(16, 16, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        st5.spmv_stencil5_const(x.t(), **KW)
    with pytest.raises(ValueError, match="dtype"):
        st5.spmv_stencil5_const(x.half(), **KW)
    with pytest.raises(ValueError, match="overlap p"):
        st5.spmv_stencil5_const_pupdate_dot(0.5, x.clone(), x, out=x, **KW)


@pytest.mark.parametrize("loop", ["recompute", "classic"])
def test_cg_on_card_matches_cpu(dev, loop):
    """The kernels' solve on the card against the plain twins' solve on the CPU, f64."""
    g = 64
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    recompute = loop == "recompute"
    op_c = ops.get_operator("stencil5-const", st, dtype=torch.float64, device=dev)
    x_c, s_c = cg.cg_solve(op_c, b_is_ones=True, recompute_ap=recompute)
    op = ops.get_operator("stencil5-const", st, dtype=torch.float64, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True, recompute_ap=recompute)
    assert s_c.converged and s_c.iterations == s.iterations
    np.testing.assert_allclose(x_c.cpu().numpy(), x.numpy(), rtol=1e-10, atol=1e-12)

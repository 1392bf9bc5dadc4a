"""The port's CUDA kernels on a card, against their plain PyTorch twins.

Every test here is marked ``cuda`` and skips without a card.  The file imports no JAX, so
it also runs where JAX is not installed; tests/conftest.py does import JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider

Tolerances, relative to the largest reference magnitude: f64 1e-12; f32 1e-5 for fields
and 1e-4 for dots (the dots sum in another order).  CG: equal iteration counts, x to rtol
1e-10.  Fields are also required to equal the twins' bit for bit where the kernels round
every operation as PyTorch does (K4, K5, K7, K8, K11 and the ELL kernel of K12/K13).
"""

import numpy as np
import pytest
import torch

from tpusparse import formats
from tpusparse.formats import Stencil5
from tpusparse_torch import convert, generate, ops
from tpusparse_torch.kernels import blas1, dia, ell
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


# (planes dtype, state dtype) of K8's four instantiations
K8_PAIRS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64)]


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("pdt,dtype", K8_PAIRS)
def test_k8_matches_twin_on_card(dev, g, pdt, dtype):
    tol_field, tol_dot = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(g)
    band = g // 2 + 1
    for rows, halos in ((g, False), (band, True)):
        planes = _randn(gen, dev, dtype, 5, rows, g).to(pdt)
        x = _randn(gen, dev, dtype, rows, g)
        hs = (_randn(gen, dev, dtype, 1, g), _randn(gen, dev, dtype, 1, g)) if halos else ()
        y, d = st5.spmv_stencil5(planes, x, *hs, with_dot=True)
        yp, dp = st5.spmv_stencil5_plain(planes, x, *hs, with_dot=True)
        assert y.dtype == dtype and torch.equal(y, yp)
        assert _rel(d, dp) <= tol_dot
        assert torch.equal(st5.spmv_stencil5(planes, x, *hs), yp)


def test_k8_on_ones_gives_the_analytic_checksums(dev):
    g = 1000
    want = generate.stencil5_spmv_checksums(g)
    for pdt, dtype in K8_PAIRS:
        planes = generate.make_stencil5_planes_device(g, dtype=pdt, device=dev)
        y = st5.spmv_stencil5(planes, generate.ones_field(g, dtype, dev)).double()
        np.testing.assert_allclose((float(y.sum()), float(torch.linalg.vector_norm(y))), want,
                                   rtol=1e-12)


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blas1_kernels_match_twins_on_card(dev, g, dtype):
    tol_field, tol_dot = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(g + 1)
    x, r, p, ap = (_randn(gen, dev, dtype, g, g) for _ in range(4))
    a = torch.tensor(0.37, dtype=dtype, device=dev)
    xk, rk, dk = blas1.cg_update(a, x.clone(), r.clone(), p, ap)
    xp, rp, dp = blas1.cg_update_plain(a, x.clone(), r.clone(), p, ap)
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and _rel(dk, dp) <= tol_dot
    assert torch.equal(blas1.p_update(a, r, p.clone()), blas1.p_update_plain(a, r, p.clone()))
    assert _rel(blas1.dot(x, r), blas1.dot_plain(x, r)) <= tol_dot
    zk, dk = blas1.axpby_dot(1.0, x, -1.0, r)
    zp, dp = blas1.axpby_dot_plain(1.0, x, -1.0, r)
    assert torch.equal(zk, zp) and torch.equal(zk, x - r) and _rel(dk, dp) <= tol_dot
    with pytest.raises(ValueError, match="r must not overlap p"):
        blas1.cg_update(a, x, r, r, ap)


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
    st5.spmv_stencil5(torch.rand(5, g, g, device=dev, dtype=torch.float64), x)
    assert st5.LAUNCHES == {"spmv_stencil5": 1, "spmv_stencil5_const": 2,
                            "spmv_stencil5_const_pupdate_dot": 1,
                            "cg_const_update_recompute": 1}
    blas1.reset_launches()
    blas1.cg_update(a, x, r, p, p.clone())
    blas1.p_update(a, r, p)
    blas1.dot(x, r)
    blas1.axpby_dot(a, x, a, r)
    blas1.dot_plain(x, r)  # twins do not count
    assert blas1.LAUNCHES == {"cg_update": 1, "p_update": 1, "dot": 1, "axpby_dot": 1}


def test_kernel_path_rejects_what_it_cannot_run(dev):
    x = torch.rand(16, 16, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        st5.spmv_stencil5_const(x.t(), **KW)
    with pytest.raises(ValueError, match="dtype"):
        st5.spmv_stencil5_const(x.half(), **KW)
    with pytest.raises(ValueError, match="overlap p"):
        st5.spmv_stencil5_const_pupdate_dot(0.5, x.clone(), x, out=x, **KW)


@pytest.mark.parametrize("mode,loop", [("stencil5-const", "recompute"),
                                       ("stencil5-const", "classic"),
                                       ("stencil5", "classic"), ("csr", "classic"),
                                       ("dia", "classic"), ("bcoo", "classic")])
@pytest.mark.parametrize("x0", [False, True])
def test_cg_on_card_matches_cpu(dev, mode, loop, x0):
    """The kernels' solve on the card against the plain twins' solve on the CPU, f64,
    from x0 = 0 (K6 for <r0, r0>) and from a seeded x0 (K7 for r0)."""
    g = 64
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    recompute = loop == "recompute"
    start = torch.from_numpy(np.random.RandomState(g).randn(g, g)) if x0 else None
    res = []
    for device in (dev, "cpu"):
        op = ops.get_operator(mode, st, dtype=torch.float64, device=device)
        b = op.ones_b()
        x0_field = None if start is None else start.reshape(op.field_shape)
        res.append(cg.cg_solve(op, b, x0_field, recompute_ap=recompute))
    (x_c, s_c), (x, s) = res
    assert s_c.converged and s_c.iterations == s.iterations
    np.testing.assert_allclose(x_c.cpu().numpy(), x.numpy(), rtol=1e-10, atol=1e-12)


def test_bf16c_solution_equals_stencil5_f32_on_card(dev):
    st = Stencil5(grid_size=256, planes=None, constant=(5.0, -1.0))
    x32, s32 = cg.cg_solve(ops.get_operator("stencil5", st, device=dev), b_is_ones=True)
    x16, s16 = cg.cg_solve(ops.get_operator("stencil5-bf16c", st, device=dev), b_is_ones=True)
    assert s32.converged and s16.iterations == s32.iterations
    assert torch.equal(x16, x32)


def _random_banded(n, bandwidth, max_row_nnz, seed):
    """Random values at random columns of a band, 1..max_row_nnz entries a row (duplicates
    kept: both kernel and twin sum them)."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), rng.randint(1, max_row_nnz + 1, n))
    cols = np.clip(rows + rng.randint(-bandwidth, bandwidth + 1, rows.size), 0, n - 1)
    return formats.coo_to_csr(formats.COOMatrix(n, n, rows, cols, rng.randn(rows.size)))


def _generic_operands(g, dtype, dev):
    """{label: (ELL operand or None, DIA operand or None)}: the stencil's, made on the
    card, and host packs of random banded and uniformly random sparsity."""
    out = {f"stencil g={g}": (generate.make_stencil5_ell_device(g, dtype=dtype, device=dev),
                              generate.make_stencil5_dia_device(g, dtype=dtype, device=dev))}
    n = g * g
    band = _random_banded(n, 40, 7, seed=g)
    e, d = formats.csr_to_ell(band), formats.csr_to_dia(band)
    out["random banded"] = (convert.ell_from_numpy(e.col, e.val, dtype, dev),
                            convert.dia_from_numpy(d.data, d.offsets, dtype, dev))
    rng = np.random.RandomState(g + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    scattered = formats.coo_to_csr(formats.COOMatrix(n, n, rows, rng.randint(0, n, 3 * n),
                                                     rng.randn(3 * n)))
    e = formats.csr_to_ell(scattered)
    out["scattered columns"] = (convert.ell_from_numpy(e.col, e.val, dtype, dev), None)
    return out


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_and_dia_match_twins_on_card(dev, g, dtype):
    _, tol_dot = TOL[dtype]
    x = _randn(torch.Generator(device=dev).manual_seed(g), dev, dtype, g * g)
    for label, (ell_op, dia_op) in _generic_operands(g, dtype, dev).items():
        for kern, plain, operand in ((ell.spmv_ell, ell.spmv_ell_plain, ell_op),
                                     (dia.spmv_dia, dia.spmv_dia_plain, dia_op)):
            if operand is None:
                continue
            y, d = kern(*operand, x, with_dot=True)
            yp, dp = plain(*operand, x, with_dot=True)
            assert torch.equal(y, yp), label
            assert torch.equal(kern(*operand, x), yp), label
            assert _rel(d, dp) <= tol_dot, label


def test_generic_kernels_on_ones_give_the_analytic_checksums(dev):
    g = 1000
    want = generate.stencil5_spmv_checksums(g)
    for dtype in (torch.float32, torch.float64):
        x = torch.ones(g * g, dtype=dtype, device=dev)
        for y in (ell.spmv_ell(*generate.make_stencil5_ell_device(g, dtype=dtype, device=dev),
                               x),
                  dia.spmv_dia(*generate.make_stencil5_dia_device(g, dtype=dtype, device=dev),
                               x)):
            y = y.double()
            np.testing.assert_allclose((float(y.sum()), float(torch.linalg.vector_norm(y))),
                                       want, rtol=1e-12)


def test_generic_wrappers_count_and_check(dev):
    n = 4096
    x = torch.rand(n, device=dev, dtype=torch.float64)
    vals, cols = convert.ell_from_numpy(np.arange(n)[:, None], np.ones((n, 1)),
                                        torch.float64, dev)
    data, offsets = convert.dia_from_numpy(np.ones((1, n)), np.zeros(1), torch.float64, dev)
    ell.reset_launches()
    dia.reset_launches()
    assert torch.equal(ell.spmv_ell(vals, cols, x), x)
    ell.spmv_ell(vals, cols, x, with_dot=True)
    ell.spmv_ell_plain(vals, cols, x)  # twins do not count
    assert torch.equal(dia.spmv_dia(data, offsets, x), x)
    dia.spmv_dia_plain(data, offsets, x)
    assert ell.LAUNCHES == {"spmv_ell": 2} and dia.LAUNCHES == {"spmv_dia": 1}
    with pytest.raises(ValueError, match="int32"):
        ell.spmv_ell(vals, cols.long(), x)
    with pytest.raises(ValueError, match="int64"):
        dia.spmv_dia(data, offsets.int(), x)
    with pytest.raises(ValueError, match="dtype|disagree|values"):
        ell.spmv_ell(vals.float(), cols, x)

"""The port's constant-stencil passes (tpusparse_torch.kernels.stencil5) against the JAX
package's Pallas kernels.

The same seeded numpy inputs go through the JAX kernel, run in Pallas interpret mode on
the CPU with ``block_rows=8`` (as tests/test_kernels_stencil5.py runs it), and through the
port's wrapper on CPU tensors, which runs its plain PyTorch twin.  Tolerances: f64
rtol/atol 1e-12, f32 1e-5 (summation order and rounding of the dots differ).

The CUDA kernels themselves are held against their twins on a card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import stencil5 as jst5
from tpusparse_torch.kernels import stencil5 as st5

GRIDS = [8, 16, 37]
KW = {"diag": 5.0, "offdiag": -1.0}
JKW = {"diag": 5.0, "offdiag": -1.0, "block_rows": 8, "interpret": True}


def _fields(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(port, ref, tol=1e-12):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("with_dot", [False, True])
def test_spmv_matches_pallas(g, with_dot):
    (x,) = _fields(g, 1, (g, g))
    ref = jst5.spmv_stencil5_const_pipelined(_j(x), with_dot=with_dot, **JKW)
    got = st5.spmv_stencil5_const(_t(x), with_dot=with_dot, **KW)
    if with_dot:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    else:
        _close(got, ref)


@pytest.mark.parametrize("g", GRIDS)
def test_plain_matches_const_xla(g):
    (x,) = _fields(g + 1, 1, (g, g))
    _close(st5.spmv_stencil5_const_plain(_t(x), **KW),
           jst5.spmv_stencil5_const_xla(_j(x), 5.0, -1.0))


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("beta", [0.0, 0.7])
def test_pupdate_dot_matches_pallas(g, beta):
    r, p = _fields(g + 2, 2, (g, g))
    pn_ref, dot_ref = jst5.spmv_stencil5_const_pupdate_dot_pipelined(beta, _j(r), _j(p), **JKW)
    rt, pt = _t(r), _t(p)
    pn, dot = st5.spmv_stencil5_const_pupdate_dot(beta, rt, pt, **KW)
    _close(pn, pn_ref)
    _close(dot, dot_ref)
    np.testing.assert_array_equal(pt.numpy(), p)  # p' never overwrites p


@pytest.mark.parametrize("g", GRIDS)
def test_update_recompute_matches_pallas(g):
    x, r, p = _fields(g + 3, 3, (g, g))
    x_ref, r_ref, rr_ref = jst5.cg_const_update_recompute_pipelined(
        0.37, _j(x), _j(r), _j(p), **JKW)
    xt, rt = _t(x.copy()), _t(r.copy())
    xo, ro, rr = st5.cg_const_update_recompute(0.37, xt, rt, _t(p), **KW)
    assert xo is xt and ro is rt  # in place, as the kernel updates them
    _close(xo, x_ref)
    _close(ro, r_ref)
    _close(rr, rr_ref)


@pytest.mark.parametrize("kernel", ["spmv", "pupdate_dot", "update_recompute"])
def test_band_with_halo_rows(kernel):
    """An interior band of a larger grid: N/S of its edge rows come from halo rows."""
    g, rows = 24, 16
    x, r, p = _fields(5, 3, (rows, g))
    hp, hn = _fields(6, 2, (1, g))
    if kernel == "spmv":
        ref = jst5.spmv_stencil5_const_pipelined(_j(x), _j(hp), _j(hn), with_dot=True, **JKW)
        got = st5.spmv_stencil5_const(_t(x), _t(hp), _t(hn), with_dot=True, **KW)
    elif kernel == "pupdate_dot":
        ref = jst5.spmv_stencil5_const_pupdate_dot_pipelined(0.7, _j(r), _j(p), _j(hp),
                                                             _j(hn), **JKW)
        got = st5.spmv_stencil5_const_pupdate_dot(0.7, _t(r), _t(p), _t(hp), _t(hn), **KW)
    else:
        ref = jst5.cg_const_update_recompute_pipelined(0.37, _j(x), _j(r), _j(p), _j(hp),
                                                       _j(hn), **JKW)
        got = st5.cg_const_update_recompute(0.37, _t(x.copy()), _t(r.copy()), _t(p), _t(hp),
                                            _t(hn), **KW)
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("kernel", ["spmv", "pupdate_dot", "update_recompute"])
def test_f32_matches_pallas(kernel):
    g = 16
    x, r, p = (a.astype(np.float32) for a in _fields(9, 3, (g, g)))
    if kernel == "spmv":
        ref = jst5.spmv_stencil5_const_pipelined(_j(x), with_dot=True, **JKW)
        got = st5.spmv_stencil5_const(_t(x), with_dot=True, **KW)
    elif kernel == "pupdate_dot":
        ref = jst5.spmv_stencil5_const_pupdate_dot_pipelined(0.7, _j(r), _j(p), **JKW)
        got = st5.spmv_stencil5_const_pupdate_dot(0.7, _t(r), _t(p), **KW)
    else:
        ref = jst5.cg_const_update_recompute_pipelined(0.37, _j(x), _j(r), _j(p), **JKW)
        got = st5.cg_const_update_recompute(0.37, _t(x.copy()), _t(r.copy()), _t(p), **KW)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b, tol=1e-5)


@pytest.mark.parametrize("g", [13, 16, 24])
@pytest.mark.parametrize("beta", [0.0, 0.7])
@pytest.mark.parametrize("halos", [False, True])
def test_const_pupdate_matches_pallas(g, beta, halos):
    """K10's twin (``spmv_stencil5_const_pupdate``) against
    ``spmv_stencil5_const_pupdate_pipelined`` in interpret mode: p' = r + β·p, y = A·p'
    and <p', y>, for β = 0 with p = 0 and β = 0.7, on a full grid or a band with halo
    rows; f64 to 1e-12.  Its p' and y equal K1's p' and K3's y of that p', bit for bit."""
    rows = g if not halos else g // 2 + 3
    r, p = _fields(g + 4, 2, (rows, g))
    if beta == 0.0:
        p = np.zeros_like(p)
    hs = _fields(g + 5, 2, (1, g)) if halos else [None, None]
    ref = jst5.spmv_stencil5_const_pupdate_pipelined(
        beta, _j(r), _j(p), *(None if h is None else _j(h) for h in hs), **JKW)
    ths = [None if h is None else _t(h) for h in hs]
    pt = _t(p)
    got = st5.spmv_stencil5_const_pupdate(beta, _t(r), pt, *ths, **KW)
    for a, b in zip(got, ref):
        _close(a, b)
    np.testing.assert_array_equal(pt.numpy(), p)
    pn, y, dot = got
    pk1, dk1 = st5.spmv_stencil5_const_pupdate_dot(beta, _t(r), pt, *ths, **KW)
    assert torch.equal(pn, pk1) and torch.equal(dot, dk1)
    assert torch.equal(y, st5.spmv_stencil5_const(pn, *ths, **KW))


def test_const_pupdate_f32_matches_pallas():
    g = 16
    r, p = (a.astype(np.float32) for a in _fields(10, 2, (g, g)))
    ref = jst5.spmv_stencil5_const_pupdate_pipelined(0.7, _j(r), _j(p), **JKW)
    got = st5.spmv_stencil5_const_pupdate(0.7, _t(r), _t(p), **KW)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b, tol=1e-5)


def test_plain_twins_do_not_count_launches():
    st5.reset_launches()
    (x,) = _fields(1, 1, (8, 8))
    st5.spmv_stencil5_const(_t(x), with_dot=True, **KW)
    st5.spmv_stencil5_const_pupdate_dot(0.5, _t(x), _t(x.copy()), **KW)
    st5.cg_const_update_recompute(0.5, _t(x.copy()), _t(x.copy()), _t(x), **KW)
    st5.spmv_stencil5_const_pupdate(0.5, _t(x), _t(x.copy()), **KW)
    assert st5.LAUNCHES == dict.fromkeys(st5.LAUNCHES, 0)


def test_non_cpu_tensor_never_reaches_the_twin():
    """Only CPU tensors take the plain twin; any other device goes to the kernel path,
    which accepts CUDA tensors alone."""
    x = torch.empty((8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        st5.spmv_stencil5_const(x, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        st5.spmv_stencil5_const_pupdate_dot(0.5, x, x, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        st5.cg_const_update_recompute(0.5, x, x, x, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        st5.spmv_stencil5_const_pupdate(0.5, x, x, **KW)


def test_pupdate_out_must_not_alias_p():
    r, p = (_t(a) for a in _fields(2, 2, (8, 8)))
    with pytest.raises(ValueError, match="overlap p"):
        st5.spmv_stencil5_const_pupdate_dot(0.5, r, p, out=p, **KW)
    out = torch.empty_like(p)
    pn, _ = st5.spmv_stencil5_const_pupdate_dot(0.5, r, p, out=out, **KW)
    assert pn is out
    with pytest.raises(ValueError, match="overlap r"):
        st5.spmv_stencil5_const_pupdate(0.5, r, p, out=r, **KW)
    pn, _, _ = st5.spmv_stencil5_const_pupdate(0.5, r, p, out=out, **KW)
    assert pn is out

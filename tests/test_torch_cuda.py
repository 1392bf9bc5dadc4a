"""The port's CUDA kernels on a card, against their plain PyTorch twins.

Every test here is marked ``cuda`` and skips without a card.  The file imports no JAX, so
it also runs where JAX is not installed; tests/conftest.py does import JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider

Tolerances, relative to the largest reference magnitude: f64 1e-12; f32 1e-5 for fields
and 1e-4 for dots (the dots sum in another order).  CG: equal iteration counts, x to rtol
1e-10.  Fields are also required to equal the twins' bit for bit where the kernels round
every operation as PyTorch does (K4, K5, K7, K8, K9, K10, K11 and the ELL kernel of
K12/K13).  The bf16-state instances (K3-K8, K11, the ELL kernel) equal their twins bit for
bit, their f32 dots within 1e-4, and a bf16 classic solve on the card converges within
one iteration of the CPU twins' solve.  K5 and K6 are also held on fields of 1, 3, 1369
and 10^6 elements in f32, f64 and bf16, aligned and offset by one element, and K6 to be
bitwise repeatable over 1000 calls and on two streams.
``bcoo`` runs in row bands on the stencil CSR made on the card.  The host-stepped solve
(``cg_solve_stepped``) is held to ``cg_solve``'s iteration count and x (f64 1e-12, f32
1e-5); a probe's chain runs as a CUDA graph, and a chain whose passes allocate a field
raises at its capture; the streaming probe kernels equal their twins; the phase scopes
reach the profiler's events.  The sharded solver runs on one rank against ``cg_solve``,
on two gloo ranks sharing the card and on four as a 2 x 2 mesh of blocks (spawned by
``dist.launch_local``, which imports this module in each rank), its pieces against their
twins: the ELL kernel's rectangular call and K3/K8 on one-row bands written into a larger
y.  K3's two bodies (the vector body, the scalar body) are each held bit for bit to the
twin at widths 1 to 4096 and bands of 1 to 2049 rows, each launch taking the body the
alignment rule names (``stencil5.const_vector_fits``; views off a 16-byte boundary take
the scalar body), and the vector body's dot is one launch, repeatable bit for bit.  K1's
and K2's two bodies are held the same way (p', x' and r' bit for bit the twin's at widths
2 to 1000 and bands of 1 to 129 rows, each operand's misaligned view taking the scalar
body, one launch a dot), K1's A·p' to K3's, K10's and K2's, and a captured recompute
solve at the benchmark's 20000² launches no scalar body.  The
graph loop (``cg.DeviceLoop``, ``cg_solve``'s default on a card) is held to the eager loop
(``graph=False``) bit for bit with equal iterations in every loop and dtype it runs, reads
the device once a solve, leaves a returned x alone, keeps device memory flat over 20
solves, frees its graphs with the operator, and its condition kernel equals its twin; its
edge cases include max_iters = 0 (the audit's fixed-overhead solve) and 1.
``scripts.audit_cg_iteration`` at 4096² launches each phase's kernel as its chains say and
closes within 80-120%.  The matrices come from the port's own ``formats`` and
``generate``: this file imports nothing of the JAX package.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpusparse_torch import convert, formats, generate, ops
from tpusparse_torch.bench import probes, profiling
from tpusparse_torch.formats import Stencil5
from tpusparse_torch.kernels import _launch, blas1, dia, ell, stream_probe
from tpusparse_torch.kernels import graph as graph_kernels
from tpusparse_torch.kernels import stencil5 as st5
from tpusparse_torch.solvers import cg

KW = {"diag": 5.0, "offdiag": -1.0}
# bf16: fields are held bit for bit; its dots are f32
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4),
       torch.bfloat16: (0.0, 1e-4)}

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


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("pdt,dtype", K8_PAIRS)
def test_fused_pupdate_kernels_match_twins_on_card(dev, g, pdt, dtype):
    """K9 in each planes/state pair and K10 in the state's dtype, for β = 0 with p = 0 and
    for β = 0.7 on a band with halo rows: p' and y bit for bit, the dot to tolerance, and
    p left as it was."""
    _, tol_dot = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(g + 2)
    band = g // 2 + 1
    for beta, rows, halos in ((0.0, g, False), (0.7, band, True)):
        r = _randn(gen, dev, dtype, rows, g)
        p = torch.zeros_like(r) if beta == 0.0 else _randn(gen, dev, dtype, rows, g)
        hs = (_randn(gen, dev, dtype, 1, g), _randn(gen, dev, dtype, 1, g)) if halos else ()
        b = torch.tensor(beta, dtype=dtype, device=dev)
        planes = _randn(gen, dev, dtype, 5, rows, g).to(pdt)
        pairs = [(st5.spmv_stencil5_pupdate(planes, b, r, p, *hs),
                  st5.spmv_stencil5_pupdate_plain(planes, b, r, p, *hs))]
        if pdt == dtype:  # K10 once per state dtype
            pairs.append((st5.spmv_stencil5_const_pupdate(b, r, p, *hs, **KW),
                          st5.spmv_stencil5_const_pupdate_plain(b, r, p, *hs, **KW)))
        p0 = p.clone()
        for (pk, yk, dk), (pp, yp, dp) in pairs:
            assert torch.equal(p, p0)  # p' went to its own buffer
            assert pk.dtype == yk.dtype == dtype
            assert torch.equal(pk, pp) and torch.equal(yk, yp)
            assert _rel(dk, dp) <= tol_dot


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
    planes = torch.rand(5, g, g, device=dev, dtype=torch.float64)
    st5.spmv_stencil5(planes, x)
    st5.spmv_stencil5_pupdate(planes, a, r, p)
    st5.spmv_stencil5_const_pupdate(a, r, p, out=x.clone(), **KW)
    st5.spmv_stencil5_const_pupdate_plain(a, r, p, **KW)
    assert st5.LAUNCHES == {"spmv_stencil5": 1, "spmv_stencil5_pupdate": 1,
                            "spmv_stencil5_const": 2, "spmv_stencil5_const_scalar": 0,
                            "spmv_stencil5_const_pupdate_dot": 1,
                            "spmv_stencil5_const_pupdate_dot_scalar": 0,
                            "cg_const_update_recompute": 1,
                            "cg_const_update_recompute_scalar": 0,
                            "spmv_stencil5_const_pupdate": 1}
    blas1.reset_launches()
    blas1.cg_update(a, x, r, p, p.clone())
    blas1.p_update(a, r, p)
    blas1.dot(x, r)
    blas1.axpby_dot(a, x, a, r)
    blas1.dot_plain(x, r)  # twins do not count
    assert blas1.LAUNCHES == {"cg_update": 1, "p_update": 1, "dot": 1, "axpby_dot": 1}
    # one K6 call is one launch on the card: the last block adds the partials
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        blas1.dot(x, r)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 1 and "dot_vec_kernel" in kernels[0][0], \
        kernels


# K3's two bodies: widths around the vector body's 16-byte vectors (1 to 16 of them, a
# ragged tile of 32 vectors, several tiles) and the scalar body's cases (g·itemsize not a
# multiple of 16)
K3_WIDTHS = [1, 7, 8, 9, 37, 64, 1000, 4096]
# band heights around the vector body's tiles of 16 rows (1, 2, one short, one, one more,
# three) and enough tiles that every block walks several (the grid is the blocks the card
# holds at once)
K3_ROWS = (1, 2, 15, 16, 17, 48, 2049)
STATES = [torch.float32, torch.float64, torch.bfloat16]


def _k3_counts():
    """(K3 launches, of which the scalar body's)."""
    return st5.LAUNCHES["spmv_stencil5_const"], st5.LAUNCHES["spmv_stencil5_const_scalar"]


@pytest.mark.parametrize("g", K3_WIDTHS)
@pytest.mark.parametrize("dtype", STATES)
def test_k3_bodies_match_twin_on_card(dev, g, dtype):
    """Both K3 bodies, with and without halo rows and the dot: y bit for bit the twin's,
    the dot within TOL of the twin's, and the vector body launched exactly when the
    alignment rule holds (fresh fields: whenever g·itemsize is a multiple of 16)."""
    gen = torch.Generator(device=dev).manual_seed(g)
    for rows in K3_ROWS:
        x = _randn(gen, dev, torch.float32, rows, g).to(dtype)
        hs = tuple(_randn(gen, dev, torch.float32, 1, g).to(dtype) for _ in range(2))
        for halos in ((), hs):
            vector = st5.const_vector_fits(x, *halos)
            assert vector == (g * x.element_size() % 16 == 0)
            yp, dp = st5.spmv_stencil5_const_plain(x, *halos, with_dot=True, **KW)
            for scalar in (False, True):
                st5.reset_launches()
                y = st5.spmv_stencil5_const(x, *halos, _scalar_body=scalar, **KW)
                yd, d = st5.spmv_stencil5_const(x, *halos, with_dot=True, _scalar_body=scalar,
                                                **KW)
                what = (rows, len(halos), "scalar" if scalar or not vector else "vector")
                assert _k3_counts() == (2, 0 if vector and not scalar else 2), what
                assert torch.equal(y, yp) and torch.equal(yd, yp), what
                assert _rel(d, dp) <= TOL[dtype][1], what


@pytest.mark.parametrize("dtype", STATES)
def test_k3_pieces_and_misaligned_views_on_card(dev, dtype):
    """The sharded SpMV's three row pieces into one y (``out=``) and a one-row piece into a
    row of a larger y take the vector body, and equal the twin over the whole band; a view
    of x, of a halo row or of ``out`` one element into its storage takes the scalar body,
    with the same y."""
    g, band = 1000, 35
    gen = torch.Generator(device=dev).manual_seed(3)
    p, hp, hn = (_randn(gen, dev, torch.float32, *s).to(dtype)
                 for s in ((band, g), (1, g), (1, g)))
    yp, dp = st5.spmv_stencil5_const_plain(p, hp, hn, with_dot=True, **KW)
    st5.reset_launches()
    y = torch.empty_like(p)
    dots = [st5.spmv_stencil5_const(p[1:-1], p[0:1], p[-1:], with_dot=True, out=y[1:-1],
                                    **KW)[1],
            st5.spmv_stencil5_const(p[0:1], hp, p[1:2], with_dot=True, out=y[0:1], **KW)[1],
            st5.spmv_stencil5_const(p[-1:], p[-2:-1], hn, with_dot=True, out=y[-1:], **KW)[1]]
    assert _k3_counts() == (3, 0)
    assert torch.equal(y, yp) and _rel(dots[0] + dots[1] + dots[2], dp) <= TOL[dtype][1]
    row = torch.zeros(3, g, device=dev, dtype=dtype)
    st5.spmv_stencil5_const(p[5:6], p[4:5], p[6:7], out=row[1:2], **KW)
    assert _k3_counts() == (4, 0)
    assert torch.equal(row[1], yp[5]) and not row[0].any() and not row[2].any()

    def shifted(t):  # a copy of t one element into its own storage
        return torch.empty(t.numel() + 1, device=dev, dtype=dtype)[1:].view(t.shape).copy_(t)

    for name, args, out in (("x", (shifted(p), hp, hn), None),
                            ("halo_next", (p, hp, shifted(hn)), None),
                            ("out", (p, hp, hn), shifted(torch.empty_like(p)))):
        assert not st5.const_vector_fits(*args, out=out), name
        st5.reset_launches()
        yk, d = st5.spmv_stencil5_const(*args, with_dot=True, out=out, **KW)
        assert _k3_counts() == (1, 1), name
        assert torch.equal(yk, yp) and _rel(d, dp) <= TOL[dtype][1], name


def test_k3_vector_dot_is_one_launch_and_repeatable(dev):
    """The vector body's dot: one launch (no final_sum_kernel, which the scalar body
    launches), bitwise equal over repeated calls, its ticket counter back at 0."""
    gen = torch.Generator(device=dev).manual_seed(4)
    for dtype in STATES:
        x = _randn(gen, dev, torch.float32, 2049, 4096).to(dtype)
        want = st5.spmv_stencil5_const(x, with_dot=True, **KW)[1]
        assert all(torch.equal(st5.spmv_stencil5_const(x, with_dot=True, **KW)[1], want)
                   for _ in range(50))
        assert _rel(want, st5.spmv_stencil5_const_plain(x, with_dot=True, **KW)[1]) \
            <= TOL[dtype][1]
        for scalar, names in ((False, ["spmv_vec_kernel"]),
                              (True, ["spmv_kernel", "final_sum_kernel"])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st5.spmv_stencil5_const(x, with_dot=True, _scalar_body=scalar, **KW)
                torch.cuda.synchronize()
            kernels = [(e.key, e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            assert len(kernels) == len(names) and all(c == 1 for _, c in kernels), kernels
            assert all(any(f"::{n}<" in k for k, _ in kernels) for n in names), kernels
    assert all(int(t) == 0 for t in _launch._TICKETS.values())


# K1's and K2's two bodies: widths of 1 to 16 16-byte vectors in f32 (4 to 64) and f64 (2
# to 32), several tiles of 32 vectors (1000), and widths that are no whole number of
# vectors (7, 37; 2 in f32), which take the scalar body
RECOMPUTE_WIDTHS = [2, 4, 7, 8, 32, 37, 64, 1000]
# band heights around a stack of K2's vector body (UPDATE_VEC_STACK tiles of 32 rows) and
# of K1's (VEC_STACK[True]): 1, one short of a stack, one stack, one more
RECOMPUTE_ROWS = (1, 63, 64, 65, 127, 128, 129)


def _recompute_counts():
    """(K1 launches, of which the scalar body's, K2 launches, of which the scalar body's)."""
    return tuple(st5.LAUNCHES[n] for n in (
        "spmv_stencil5_const_pupdate_dot", "spmv_stencil5_const_pupdate_dot_scalar",
        "cg_const_update_recompute", "cg_const_update_recompute_scalar"))


@pytest.mark.parametrize("g", RECOMPUTE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_k2_bodies_match_twin_on_card(dev, g, dtype):
    """K1 and K2 in both bodies, with and without halo rows: p', x and r bit for bit the
    twin's, the dots within TOL of the twin's and bitwise equal over two launches, and
    each launch taking the body the alignment rule names (fresh fields: the vector body
    whenever g·itemsize is a multiple of 16)."""
    gen = torch.Generator(device=dev).manual_seed(g + 24)
    vector = g * torch.empty((), dtype=dtype).element_size() % 16 == 0
    for rows in RECOMPUTE_ROWS:
        x, r, p = (_randn(gen, dev, dtype, rows, g) for _ in range(3))
        hs = (_randn(gen, dev, dtype, 1, g), _randn(gen, dev, dtype, 1, g))
        b = torch.tensor(0.37, dtype=dtype, device=dev)
        a = torch.tensor(-0.61, dtype=dtype, device=dev)
        for halos in ((), hs):
            pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(b, r, p, *halos, **KW)
            xp, rp, rrp = st5.cg_const_update_recompute_plain(a, x.clone(), r.clone(), p,
                                                              *halos, **KW)
            for scalar in (False, True):
                what = (rows, len(halos), "scalar" if scalar or not vector else "vector")
                st5.reset_launches()
                k1 = [st5.spmv_stencil5_const_pupdate_dot(b, r, p, *halos, _scalar_body=scalar,
                                                          **KW) for _ in range(2)]
                k2 = [st5.cg_const_update_recompute(a, x.clone(), r.clone(), p, *halos,
                                                    _scalar_body=scalar, **KW)
                      for _ in range(2)]
                once = 0 if vector and not scalar else 2
                assert _recompute_counts() == (2, once, 2, once), what
                for pk, dk in k1:
                    assert torch.equal(pk, pp) and _rel(dk, dp) <= TOL[dtype][1], what
                for xk, rk, rrk in k2:
                    assert torch.equal(xk, xp) and torch.equal(rk, rp), what
                    assert _rel(rrk, rrp) <= TOL[dtype][1], what
                assert torch.equal(k1[0][1], k1[1][1]) and torch.equal(k2[0][2], k2[1][2]), what


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_shares_a_p_with_k2_k3_and_k10_on_card(dev, dtype):
    """K1's vector body forms the A·p' of K3, K10 and K2: its p' is K10's bit for bit, its
    dot is K3's vector dot over p' bit for bit (the same tiles, stack and order), and K2's
    vector body with α = -1 on x = r = 0 leaves r' = A·p', K10's y bit for bit."""
    g, rows = 1000, 300
    gen = torch.Generator(device=dev).manual_seed(10)
    r, p = (_randn(gen, dev, dtype, rows, g) for _ in range(2))
    hs = (_randn(gen, dev, dtype, 1, g), _randn(gen, dev, dtype, 1, g))
    b = torch.tensor(0.37, dtype=dtype, device=dev)
    st5.reset_launches()
    pk, dk = st5.spmv_stencil5_const_pupdate_dot(b, r, p, *hs, **KW)
    p10, y10, _ = st5.spmv_stencil5_const_pupdate(b, r, p, *hs, **KW)
    _, d3 = st5.spmv_stencil5_const(pk, *hs, with_dot=True, **KW)
    minus = torch.tensor(-1.0, dtype=dtype, device=dev)
    _, ap, _ = st5.cg_const_update_recompute(minus, torch.zeros_like(pk), torch.zeros_like(pk),
                                             pk, *hs, **KW)
    assert _recompute_counts() == (1, 0, 1, 0)
    assert torch.equal(pk, p10) and torch.equal(dk, d3) and torch.equal(ap, y10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_k2_misaligned_views_take_the_scalar_body_on_card(dev, dtype):
    """A view one element into its storage of any operand K1 or K2 reads or writes fails
    the alignment rule, and the launch takes the scalar body, adds one to its scalar count
    and gives the twin's fields; the aligned launch adds nothing there."""
    g, rows = 1000, 35
    gen = torch.Generator(device=dev).manual_seed(5)
    x, r, p, hp, hn = (_randn(gen, dev, dtype, *s)
                       for s in ((rows, g), (rows, g), (rows, g), (1, g), (1, g)))
    b = torch.tensor(0.37, dtype=dtype, device=dev)
    pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(b, r, p, hp, hn, **KW)
    xp, rp, rrp = st5.cg_const_update_recompute_plain(b, x.clone(), r.clone(), p, hp, hn, **KW)

    def shifted(t):  # a copy of t one element into its own storage
        return torch.empty(t.numel() + 1, device=dev, dtype=dtype)[1:].view(t.shape).copy_(t)

    k1 = {"aligned": (r, p, hp, hn, None), "r": (shifted(r), p, hp, hn, None),
          "p": (r, shifted(p), hp, hn, None), "halo_prev": (r, p, shifted(hp), hn, None),
          "halo_next": (r, p, hp, shifted(hn), None),
          "out": (r, p, hp, hn, shifted(torch.empty_like(r)))}
    for name, (rk, pk, hpk, hnk, out) in k1.items():
        st5.reset_launches()
        pn, d = st5.spmv_stencil5_const_pupdate_dot(b, rk, pk, hpk, hnk, out=out, **KW)
        fits = st5.const_vector_fits(rk, hpk, hnk, pn, fields=(pk,))
        assert fits == (name == "aligned"), name
        assert _recompute_counts()[:2] == (1, int(not fits)), name
        assert torch.equal(pn, pp) and _rel(d, dp) <= TOL[dtype][1], name
    k2 = {"aligned": (x, r, p, hp, hn), "x": (shifted(x), r, p, hp, hn),
          "r": (x, shifted(r), p, hp, hn), "p": (x, r, shifted(p), hp, hn),
          "halo_prev": (x, r, p, shifted(hp), hn), "halo_next": (x, r, p, hp, shifted(hn))}
    for name, (xk, rk, pk, hpk, hnk) in k2.items():
        xk, rk = (shifted(t) if t.data_ptr() % 16 else t.clone() for t in (xk, rk))
        fits = st5.const_vector_fits(rk, hpk, hnk, fields=(xk, pk))
        assert fits == (name == "aligned"), name
        st5.reset_launches()
        xn, rn, rr = st5.cg_const_update_recompute(b, xk, rk, pk, hpk, hnk, **KW)
        assert _recompute_counts()[2:] == (1, int(not fits)), name
        assert torch.equal(xn, xp) and torch.equal(rn, rp), name
        assert _rel(rr, rrp) <= TOL[dtype][1], name


def test_k1_k2_vector_dots_are_one_launch(dev):
    """K1's and K2's vector bodies finish their dots in their own launch (no
    final_sum_kernel, which the scalar bodies launch after theirs), their ticket counter
    back at 0."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        x, r, p, r2 = (_randn(gen, dev, dtype, 2049, 4096) for _ in range(4))
        b = torch.tensor(0.37, dtype=dtype, device=dev)
        calls = {"pupdate_dot": lambda sc: st5.spmv_stencil5_const_pupdate_dot(
                     b, r, p, _scalar_body=sc, **KW),
                 "update_recompute": lambda sc: st5.cg_const_update_recompute(
                     b, x, r2, p, _scalar_body=sc, **KW)}
        for stem, call in calls.items():
            for scalar, names in ((False, [f"{stem}_vec_kernel"]),
                                  (True, [f"{stem}_kernel", "final_sum_kernel"])):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call(scalar)
                    torch.cuda.synchronize()
                kernels = [(e.key, e.count) for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                assert len(kernels) == len(names) and all(c == 1 for _, c in kernels), kernels
                assert all(any(f"::{n}<" in k for k, _ in kernels) for n in names), kernels
    assert all(int(t) == 0 for t in _launch._TICKETS.values())


def _twin_recompute_solve(g, dtype, dev, tol=1e-6, max_iters=1000):
    """The recompute loop of ``cg._eager_loop`` from b = ones and x = 0 on the card,
    every pass the plain twin's: its iteration count."""
    r = torch.ones((g, g), dtype=dtype, device=dev)
    x, p_prev = torch.zeros_like(r), torch.zeros_like(r)
    rr = bb = blas1.dot_plain(r, r)
    tol2 = tol * tol * bb
    rr_prev, k = torch.ones_like(rr), 0
    while k < max_iters and bool(rr > tol2):
        beta = torch.zeros_like(rr) if k == 0 else rr / rr_prev
        p, pap = st5.spmv_stencil5_const_pupdate_dot_plain(beta, r, p_prev, **KW)
        x, r, rr_new = st5.cg_const_update_recompute_plain(rr / pap, x, r, p, **KW)
        p_prev, rr_prev, rr = p, rr, rr_new
        k += 1
    return k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recompute_solve_at_20000_takes_the_vector_bodies(dev, dtype):
    """The benchmark's shape: a captured recompute solve at g = 20000 launches K1's and
    K2's vector bodies only (their scalar counts stay 0 in its capture and its replays)
    and converges in the iteration count of the plain twins' loop on the card."""
    g = 20000
    k_twin = _twin_recompute_solve(g, dtype, dev)
    torch.cuda.empty_cache()
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=dtype, device=dev)
    x, s, eager, replayed, counts = _solve_counted(op, b_is_ones=True)
    del x
    per = op.graphs[cg.DeviceLoop.key(op, "recompute", 1000, 1e-6)].per_iteration
    op.free()
    assert counts["replays"] == 1 and s.converged and s.iterations == k_twin
    assert per == {"spmv_stencil5_const_pupdate_dot": 1, "cg_const_update_recompute": 1}
    assert replayed["spmv_stencil5_const_pupdate_dot"] == s.iterations
    assert not any(replayed.get(n, 0) or eager.get(n, 0)
                   for n in ("spmv_stencil5_const_pupdate_dot_scalar",
                             "cg_const_update_recompute_scalar"))


def _offset_copy(t, offset):
    """A copy of the 1-D field t that lies ``offset`` elements into its own storage."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:]
    return out.copy_(t)


# (r or a, p or b) elements into their storage: both at 16-byte boundaries (the main
# path's fresh fields), one a view one element in, both one element in
ALIGNMENTS = {"aligned": (0, 0), "one offset": (1, 0), "both offset": (1, 1)}


@pytest.mark.parametrize("n", [1, 3, 1369, 10 ** 6])
@pytest.mark.parametrize("align", list(ALIGNMENTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_k5_k6_any_size_and_alignment(dev, n, align, dtype):
    """K5's p bit for bit and K6 within TOL, in the vector body (both operands at one
    offset mod 16 bytes: a scalar head, vectors, a scalar tail) and in the scalar body."""
    _, tol_dot = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(n)
    off_r, off_p = ALIGNMENTS[align]
    r = _offset_copy(_randn(gen, dev, torch.float32, n).to(dtype), off_r)
    p = _offset_copy(_randn(gen, dev, torch.float32, n).to(dtype), off_p)
    assert ((r.data_ptr() - p.data_ptr()) % 16 == 0) == (align != "one offset")
    beta = torch.tensor(0.37, dtype=dtype, device=dev)
    pk = blas1.p_update(beta, r, _offset_copy(p, off_p))
    assert torch.equal(pk, blas1.p_update_plain(beta, r, p.clone()))
    assert _rel(blas1.dot(r, p), blas1.dot_plain(r, p)) <= tol_dot
    assert _rel(blas1.dot(r, r), blas1.dot_plain(r, r)) <= tol_dot


def test_k6_is_bitwise_repeatable_across_calls_and_streams(dev):
    """1000 calls in a row, then calls on two streams at once, each with its own ticket
    counter: every dot equal bit for bit, and every counter back at 0."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for dtype in (torch.float32, torch.float64):
        a, b = (_randn(gen, dev, dtype, 10 ** 6 + 5) for _ in range(2))
        want = blas1.dot(a, b)
        outs = [blas1.dot(a, b) for _ in range(1000)]
        streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
        torch.cuda.synchronize()
        for _ in range(20):
            for s in streams:
                with torch.cuda.stream(s):
                    outs.append(blas1.dot(a, b))
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
        assert _rel(want, blas1.dot_plain(a, b)) <= TOL[dtype][1]
    keys = {(a.device, s.cuda_stream) for s in streams}
    assert keys <= set(_launch._TICKETS)
    assert all(int(t) == 0 for t in _launch._TICKETS.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bcoo_bands_on_card(dev, monkeypatch, dtype):
    """``bcoo`` on the g = 200 stencil's CSR made on the card, in bands of at most 50,000
    entries (4 bands), against the ELL kernel's y and the one-band y; CG over the bands in
    the CPU solve's iteration count."""
    tol_field, tol_dot = TOL[dtype]
    g = 200
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    x = _randn(torch.Generator(device=dev).manual_seed(g), dev, dtype, g * g)
    y_ell = ell.spmv_ell(*generate.make_stencil5_ell_device(g, dtype=dtype, device=dev), x)
    y_one = ops.get_operator("bcoo", st, dtype=dtype, device=dev).run_device(x)
    monkeypatch.setattr(ops, "BCOO_BAND_ENTRIES", 50_000)
    op = ops.get_operator("bcoo", st, dtype=dtype, device=dev)
    assert len(op.operand["bands"]) == 4
    y, d = op.run_device_dot(x)
    assert _rel(y, y_ell) <= tol_field and _rel(y_one, y_ell) <= tol_field
    assert _rel(d, blas1.dot_plain(x, y_ell)) <= tol_dot
    x_card, s = cg.cg_solve(op, b_is_ones=True)
    x_cpu, s_cpu = cg.cg_solve(ops.get_operator("bcoo", st, dtype=dtype, device="cpu"),
                               b_is_ones=True)
    assert s.converged and s.iterations == s_cpu.iterations
    assert _rel(x_card.cpu(), x_cpu) <= tol_field


def test_kernel_path_rejects_what_it_cannot_run(dev):
    x = torch.rand(16, 16, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        st5.spmv_stencil5_const(x.t(), **KW)
    with pytest.raises(ValueError, match="dtype"):
        st5.spmv_stencil5_const(x.half(), **KW)
    with pytest.raises(ValueError, match="overlap p"):
        st5.spmv_stencil5_const_pupdate_dot(0.5, x.clone(), x, out=x, **KW)
    with pytest.raises(ValueError, match="overlap r"):
        st5.spmv_stencil5_const_pupdate(0.5, x, x.clone(), out=x, **KW)
    with pytest.raises(ValueError, match="planes"):
        st5.spmv_stencil5_pupdate(torch.rand(5, 8, 16, device=dev, dtype=torch.float64), 0.5,
                                  x, x.clone())


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


@pytest.mark.parametrize("mode,dtype", [("stencil5-const", torch.float64),
                                        ("stencil5", torch.float64),
                                        ("stencil5-bf16c", torch.float32)])
def test_fused_cg_on_card(dev, mode, dtype):
    """The fused p-update loop (K9 or K10, K4, K6) on the card: its iteration count equals
    the classic solve's, and x the plain twins' fused solve on the CPU."""
    g = 64
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator(mode, st, dtype=dtype, device=dev)
    st5.reset_launches()
    cg.reset_launches()
    x, s = cg.cg_solve(op, b_is_ones=True, fused_pupdate=True)
    fused = ("spmv_stencil5_const_pupdate" if mode == "stencil5-const"
             else "spmv_stencil5_pupdate")
    # the graph loop's replays count in cg.LAUNCHES, the wrappers' eager launches in theirs
    assert st5.LAUNCHES[fused] + cg.LAUNCHES.get(fused, 0) == s.iterations
    assert st5.LAUNCHES["spmv_stencil5"] == st5.LAUNCHES["spmv_stencil5_const"] == 0
    _, s_classic = cg.cg_solve(op, b_is_ones=True, recompute_ap=False)
    cpu = ops.get_operator(mode, st, dtype=dtype, device="cpu")
    x_c, s_c = cg.cg_solve(cpu, b_is_ones=True, fused_pupdate=True)
    assert s.converged and s.iterations == s_classic.iterations == s_c.iterations
    rtol, atol = (1e-10, 1e-12) if dtype == torch.float64 else (1e-5, 1e-6)
    np.testing.assert_allclose(x.cpu().numpy(), x_c.numpy(), rtol=rtol, atol=atol)


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


@pytest.mark.parametrize("g", [37, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stepped_cg_on_card_matches_cg_solve(dev, g, dtype):
    """The host-stepped classic loop (K8 with its dot, K4, K5; K6 for <r0, r0>) against
    cg_solve's classic loop on the same operator: equal iteration counts, x to 1e-12 in
    f64 and 1e-5 in f32, every phase bucket > 0 and their sum within the loop's time."""
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=dtype, device=dev)
    x_ref, s_ref = cg.cg_solve(op, b_is_ones=True)
    st5.reset_launches()
    blas1.reset_launches()
    x, s = cg.cg_solve_stepped(op.run_device_dot, op.ones_b())
    assert s.converged and s.iterations == s_ref.iterations
    assert st5.LAUNCHES["spmv_stencil5"] == s.iterations
    assert blas1.LAUNCHES["cg_update"] == s.iterations
    assert blas1.LAUNCHES["p_update"] == s.iterations - 1 and blas1.LAUNCHES["dot"] == 1
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(x, x_ref) <= rtol
    buckets = (s.spmv_time_ms, s.blas1_time_ms, s.reduction_time_ms)
    assert min(buckets) > 0 and sum(buckets) <= s.total_time_ms


def test_probe_chain_is_a_graph_that_does_not_allocate(dev):
    """A chain is checked where the allocator can see it, at its capture (a replay never
    calls the allocator): the copy chain and the read chain (torch.sum allocates its
    few-KB partials per call) capture, a planted pass that writes a temporary field
    raises; a chain's GB/s is finite and positive; the probe set reads under the card's
    data-sheet peak or says which probe did not."""
    x = torch.ones(2 ** 22, device=dev)
    nbytes = 4 * 2 ** 22
    for one_pass, moved in ((probes._copy_probe(x), 2 * nbytes), (probes._read_probe(x), nbytes),
                            (probes._read_kernel_probe(x), nbytes)):
        run = probes._chain(one_pass, 8, dev, moved)
        run()
    torch.cuda.synchronize()
    v, c = x.clone(), torch.tensor(1.0000001)
    with pytest.raises(RuntimeError, match="allocated"):
        probes._chain(lambda: v * c, 8, dev, 2 * nbytes)
    gbs = probes.measure_probe_slope(probes._copy_probe, (x,), 2 * nbytes, 4, 16, 2)
    assert np.isfinite(gbs) and gbs > 0
    r = probes.measure_achievable_bw(n_elems=2 ** 24, device=dev)
    assert r["probes"] == list(probes.PROBES)
    assert r["achievable_gbs"] == max(r[f"{p}_gbs"] for p in r["probes"]
                                      if p not in r["probes_over_peak"])


@pytest.mark.parametrize("n", [8, 1024, 2 ** 20 + 4, 2 ** 24])
def test_stream_probe_kernels_match_twins(dev, n):
    """The streaming probe kernels: the read's partials sum to the field's sum (f32
    partials, 1e-5 relative to the sum of magnitudes), the copy equals its source bit for
    bit; each wrapper counts its launches; fields that are no whole 16-byte vectors raise."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, dev, torch.float32, n)
    stream_probe.reset_launches()
    part = torch.empty(stream_probe.read_partials(x), device=dev)
    total = float(stream_probe.read(x, part).double().sum())
    assert abs(total - float(x.double().sum())) <= 1e-5 * float(x.double().abs().sum())
    dst = torch.empty_like(x)
    assert torch.equal(stream_probe.copy(x, dst), x)
    assert stream_probe.LAUNCHES == {"probe_read": 1, "probe_copy": 1}
    with pytest.raises(ValueError, match="multiple of 4"):
        stream_probe.copy(x[:n - 1], dst[:n - 1])
    with pytest.raises(ValueError, match="16-byte"):
        stream_probe.copy(x[1:n - 3], dst[:n - 4])
    with pytest.raises(ValueError, match="partials"):
        stream_probe.read(x, part[:0])


def test_scopes_reach_the_profiler(dev, tmp_path):
    """A profiled classic solve of the eager loop carries the phase names (record_function,
    with NVTX ranges of the same names) and the kernels' names in its trace.  (The graph
    loop enters its scopes at capture only: ``test_graph_kernels_reach_the_profiler``.)"""
    import json

    st = Stencil5(grid_size=64, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cg.cg_solve(op, b_is_ones=True, graph=False)
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    assert {profiling.PHASE_SPMV, profiling.PHASE_AXPY, profiling.PHASE_UPDATE_P} <= keys
    profiling.profiled_run(cg.cg_solve_stepped, op.run_device_dot, op.ones_b(),
                           logdir=str(tmp_path))
    (trace,) = tmp_path.glob("*.json")
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"SpMV", "BLAS_AXPY", "BLAS_Update_P", "Dot_Product"} <= names
    for kernel in ("spmv_planes_kernel", "cg_update_kernel", "p_update"):
        assert any(kernel in n for n in names), kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rectangular_ell_matches_twin_on_card(dev, dtype):
    """The ELL kernel over a gather domain: a band of rows [lo, hi) of the g = 37 stencil,
    columns rebased into [halo_prev; band; halo_next], against its twin (y bit for bit,
    the band's own dot from ``dot_offset``)."""
    g, lo, hi = 37, 10, 20
    vals, cols = generate.make_stencil5_ell_device(g, dtype=dtype, device=dev, rows=(lo, hi))
    cols = cols - (lo * g - g)
    dom = _randn(torch.Generator(device=dev).manual_seed(3), dev, dtype, (hi - lo + 2) * g)
    ell.reset_launches()
    y, d = ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=g)
    yp, dp = ell.spmv_ell_plain(vals, cols, dom, with_dot=True, dot_offset=g)
    assert y.shape == ((hi - lo) * g,) and torch.equal(y, yp)
    assert _rel(d, dp) <= TOL[dtype][1]
    assert ell.LAUNCHES == {"spmv_ell": 1}
    with pytest.raises(ValueError, match="dot_offset"):
        ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=3 * g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_row_pieces_match_twins_on_card(dev, dtype):
    """K8 and K3 on bands of one row with both halo rows, written into a row of a larger
    y (``out=``): the sharded solver's boundary rows."""
    g = 1000
    gen = torch.Generator(device=dev).manual_seed(1)
    x, hp, hn = (_randn(gen, dev, dtype, 1, g) for _ in range(3))
    planes = _randn(gen, dev, dtype, 5, 1, g)
    y = torch.zeros(3, g, device=dev, dtype=dtype)
    _, d = st5.spmv_stencil5(planes, x, hp, hn, with_dot=True, out=y[1:2])
    yp, dp = st5.spmv_stencil5_plain(planes, x, hp, hn, with_dot=True)
    assert torch.equal(y[1:2], yp) and not y[0].any() and not y[2].any()
    assert _rel(d, dp) <= TOL[dtype][1]
    _, d = st5.spmv_stencil5_const(x, hp, hn, with_dot=True, out=y[0:1], **KW)
    yp, dp = st5.spmv_stencil5_const_plain(x, hp, hn, with_dot=True, **KW)
    assert _rel(y[0:1], yp) <= TOL[dtype][0] and _rel(d, dp) <= TOL[dtype][1]
    with pytest.raises(ValueError, match="overlap"):
        st5.spmv_stencil5_const(x, hp, hn, out=hp, **KW)


def test_sharded_one_rank_on_card_equals_cg_solve(dev):
    """The sharded solve on one rank (no process group) at g = 1000, f64, against
    ``cg.cg_solve`` on the same card: identical iterations, x to 1e-12, through K8, K4,
    K5 and K6."""
    from tpusparse_torch.solvers import cg_sharded

    g = 1000
    op = ops.get_operator("stencil5", Stencil5(grid_size=g, planes=None,
                                               constant=(5.0, -1.0)),
                          dtype=torch.float64, device=dev)
    x_ref, s_ref = cg.cg_solve(op, b_is_ones=True)
    st5.reset_launches()
    blas1.reset_launches()
    x, s = cg_sharded.cg_solve_sharded(g, mode="stencil5", dtype=torch.float64, device=dev)
    cg_sharded.clear_caches()
    assert s.converged and s.iterations == s_ref.iterations
    assert _rel(x, x_ref) <= 1e-12
    assert st5.LAUNCHES["spmv_stencil5"] == s.iterations
    assert blas1.LAUNCHES["cg_update"] == blas1.LAUNCHES["p_update"] == s.iterations
    assert blas1.LAUNCHES["dot"] == 1


def _two_ranks_on_card(device):
    """Each rank: stencil5 (overlapped), stencil5-const recompute and csr at g = 64, f64,
    its kernels' launches and those given an exchanged halo row, and the solutions
    gathered to rank 0."""
    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    out = {}
    for mode in ("stencil5", "stencil5-const", "csr"):
        for counter in (st5, blas1, ell):
            counter.reset_launches()
        cg_sharded.reset_halo_calls()
        x, s = cg_sharded.cg_solve_sharded(64, mode=mode, dtype=torch.float64, device=device)
        launched = {**st5.LAUNCHES, **ell.LAUNCHES}
        halos = {k: min(v, launched[k]) for k, v in cg_sharded.HALO_CALLS.items()
                 if v and k != "exchange"}
        out[mode] = (dist.gather_to_host(x, rows=64), s.iterations,
                     dist._all_objects((cg_sharded.HALO_CALLS["exchange"], halos)))
    return out


def test_two_ranks_share_the_card(dev):
    """Two gloo ranks on one card, halos staged through pinned host memory: each mode's
    solution against the one-device solve on the CPU (iterations identical, x to 1e-12),
    and every rank exchanged rows once an iteration and launched its path's kernels on
    them."""
    from tpusparse_torch import dist

    got = dist.launch_local(_two_ranks_on_card, 2, device="cuda")
    want_halo = {"stencil5": {"spmv_stencil5"},
                 "stencil5-const": {"spmv_stencil5_const_pupdate_dot",
                                    "cg_const_update_recompute"},
                 "csr": {"spmv_ell"}}
    st = Stencil5(grid_size=64, planes=None, constant=(5.0, -1.0))
    for mode, (x, iterations, halos) in got.items():
        ref, s_ref = cg.cg_solve(ops.get_operator(mode, st, dtype=torch.float64,
                                                  device="cpu"), b_is_ones=True)
        assert iterations == s_ref.iterations
        assert _rel(torch.from_numpy(x), ref.reshape(64, 64)) <= 1e-12
        assert all(ex == iterations and want_halo[mode] <= set(h) for ex, h in halos), \
            (mode, halos)


def _mesh_2x2_on_card(device):
    """Each rank of a 2 x 2 mesh at g = 1024, f64: the 2-D classic solve with its launches
    and halo counts, then one SpMV of a seeded x, overlapped and synchronous; solution and
    y gathered to rank 0."""
    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    mesh, g = (2, 2), 1024
    st5.reset_launches()
    blas1.reset_launches()
    cg_sharded.reset_halo_calls()
    x, s = cg_sharded.cg_solve_sharded_2d(mesh, g, dtype=torch.float64, device=device)
    counts = dist._all_objects((st5.LAUNCHES["spmv_stencil5"], dict(blas1.LAUNCHES),
                                dict(cg_sharded.HALO_CALLS)))
    field = np.random.RandomState(5).randn(g, g)
    ys = []
    for overlap in (True, False):
        op = cg_sharded.make_sharded_operator(g, mesh_shape=mesh, dtype=torch.float64,
                                              overlap=overlap, device=device)
        y, pap = op.local_spmv_dot(op.band_of(field))
        ys.append((dist.gather_blocks_to_host(y, mesh), float(pap)))
    out = (dist.gather_blocks_to_host(x, mesh), s.iterations, counts, ys, field)
    cg_sharded.clear_caches()
    return out


def test_2x2_mesh_shares_the_card(dev):
    """Four gloo ranks on one card, a 2 x 2 mesh of 512² blocks: the solution against
    ``cg.cg_solve`` on the card (iterations identical, x to 1e-12), every rank's K8 (three
    row pieces an iteration), K4, K5 and K6 launched and its rows and columns exchanged
    once an iteration, each column consumed by its side-column correction; the overlapped
    SpMV's y bit for bit the synchronous one's and, to 1e-12, the plain stencil's on the
    whole grid."""
    from tpusparse_torch import dist

    x, iterations, counts, ys, field = dist.launch_local(_mesh_2x2_on_card, 4, device="cuda")
    g = 1024
    op = ops.get_operator("stencil5", Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0)),
                          dtype=torch.float64, device=dev)
    x_ref, s_ref = cg.cg_solve(op, b_is_ones=True)
    assert iterations == s_ref.iterations
    assert _rel(torch.from_numpy(x), x_ref.cpu().reshape(g, g)) <= 1e-12
    for k8, b1, halo in counts:
        # K6: <r0, r0>, and the side column's term of <p, A·p> once an iteration
        assert k8 == 3 * iterations and b1["dot"] == 1 + iterations
        assert b1["cg_update"] == b1["p_update"] == iterations
        assert halo["exchange"] == halo["column_exchange"] == iterations
        assert halo["spmv_stencil5"] == halo["column_correction"] == iterations
    (ya, da), (yb, db) = ys
    np.testing.assert_array_equal(ya, yb)
    planes = generate.make_stencil5_planes_device(g, dtype=torch.float64, device="cpu")
    y_ref, d_ref = st5.spmv_stencil5_plain(planes, torch.from_numpy(field), with_dot=True)
    assert _rel(torch.from_numpy(ya), y_ref) <= 1e-12
    assert abs(da - float(d_ref)) <= 1e-12 * abs(float(d_ref))
    assert abs(da - db) <= 1e-14 * abs(db)


BF16 = torch.bfloat16


def _bf16_dot(d, dp):
    assert d.dtype == torch.float32 and _rel(d, dp) <= TOL[BF16][1]


@pytest.mark.parametrize("g", [37, 1000])
def test_bf16_kernels_match_twins_on_card(dev, g):
    """Every bf16-state instance against its twin, bit for bit: K3 and K8 (bf16 planes) on
    the grid and on a band with halo rows, K4-K7, K11 and the ELL kernel on the stencil's
    operands, square and over a gather domain; K1, K2, K9 and K10 refuse a bf16 state."""
    gen = torch.Generator(device=dev).manual_seed(g + 16)

    def rnd(*shape):
        return _randn(gen, dev, torch.float32, *shape).to(BF16)

    x, r, p, ap = (rnd(g, g) for _ in range(4))
    hp, hn = rnd(1, g), rnd(1, g)
    a, b = (torch.tensor(v, dtype=BF16, device=dev) for v in (0.37, -0.61))
    planes = rnd(5, g, g)
    for hs in ((), (hp, hn)):
        y, d = st5.spmv_stencil5_const(x, *hs, with_dot=True, **KW)
        yp, dp = st5.spmv_stencil5_const_plain(x, *hs, with_dot=True, **KW)
        assert y.dtype == BF16 and torch.equal(y, yp)
        _bf16_dot(d, dp)
        y, d = st5.spmv_stencil5(planes, x, *hs, with_dot=True)
        yp, dp = st5.spmv_stencil5_plain(planes, x, *hs, with_dot=True)
        assert y.dtype == BF16 and torch.equal(y, yp)
        assert torch.equal(st5.spmv_stencil5(planes, x, *hs), yp)
        _bf16_dot(d, dp)
    xk, rk, dk = blas1.cg_update(a, x.clone(), r.clone(), p, ap)
    xp, rp, dp = blas1.cg_update_plain(a, x.clone(), r.clone(), p, ap)
    assert torch.equal(xk, xp) and torch.equal(rk, rp)
    _bf16_dot(dk, dp)
    assert torch.equal(blas1.p_update(b, r, p.clone()), blas1.p_update_plain(b, r, p.clone()))
    _bf16_dot(blas1.dot(x, r), blas1.dot_plain(x, r))
    zk, dk = blas1.axpby_dot(a, x, b, r)
    zp, dp = blas1.axpby_dot_plain(a, x, b, r)
    assert torch.equal(zk, zp)
    _bf16_dot(dk, dp)
    xf = x.reshape(-1)
    for kern, plain, operand in (
            (ell.spmv_ell, ell.spmv_ell_plain,
             generate.make_stencil5_ell_device(g, dtype=BF16, device=dev)),
            (dia.spmv_dia, dia.spmv_dia_plain,
             generate.make_stencil5_dia_device(g, dtype=BF16, device=dev)),
            (dia.spmv_dia, dia.spmv_dia_plain,
             (rnd(5, g * g), torch.tensor([-g, -1, 0, 1, g], device=dev)))):
        y, d = kern(*operand, xf, with_dot=True)
        yp, dp = plain(*operand, xf, with_dot=True)
        assert y.dtype == BF16 and torch.equal(y, yp)
        _bf16_dot(d, dp)
    lo, hi = g // 4, g // 2
    vals, cols = generate.make_stencil5_ell_device(g, dtype=BF16, device=dev, rows=(lo, hi))
    cols = cols - (lo * g - g)
    dom = rnd((hi - lo + 2) * g)
    y, d = ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=g)
    yp, dp = ell.spmv_ell_plain(vals, cols, dom, with_dot=True, dot_offset=g)
    assert y.shape == ((hi - lo) * g,) and torch.equal(y, yp)
    _bf16_dot(d, dp)
    for refused in (lambda: st5.spmv_stencil5_const_pupdate_dot(a, r, p, **KW),
                    lambda: st5.cg_const_update_recompute(a, x, r, p, **KW),
                    lambda: st5.spmv_stencil5_const_pupdate(a, r, p, **KW),
                    lambda: st5.spmv_stencil5_pupdate(planes, a, r, p)):
        with pytest.raises(ValueError, match="bf16"):
            refused()


def test_bf16_one_row_pieces_match_twins_on_card(dev):
    """K8 and K3 at bf16 on a band of one row with both halo rows, written into a row of a
    larger y (``out=``): the sharded solver's boundary rows."""
    g = 1000
    gen = torch.Generator(device=dev).manual_seed(2)
    x, hp, hn = (_randn(gen, dev, torch.float32, 1, g).to(BF16) for _ in range(3))
    planes = _randn(gen, dev, torch.float32, 5, 1, g).to(BF16)
    y = torch.zeros(3, g, device=dev, dtype=BF16)
    _, d = st5.spmv_stencil5(planes, x, hp, hn, with_dot=True, out=y[1:2])
    yp, dp = st5.spmv_stencil5_plain(planes, x, hp, hn, with_dot=True)
    assert torch.equal(y[1:2], yp) and not y[0].any() and not y[2].any()
    _bf16_dot(d, dp)
    _, d = st5.spmv_stencil5_const(x, hp, hn, with_dot=True, out=y[0:1], **KW)
    yp, dp = st5.spmv_stencil5_const_plain(x, hp, hn, with_dot=True, **KW)
    assert torch.equal(y[0:1], yp)
    _bf16_dot(d, dp)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-bf16c", "stencil5-const", "csr",
                                  "dia", "bcoo"])
def test_bf16_classic_solve_on_card(dev, mode):
    """A bf16 state's classic solve at g = 64 through the bf16 kernels on the card, against
    the CPU twins' solve: both converge, iterations within one, Sum(x) and Norm2(x) within
    1e-2 (their dots sum in other orders, and a bf16 CG's x is noise below ~5e-3); the
    recompute loop refuses it."""
    g = 64
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    runs = []
    for device in (dev, "cpu"):
        op = ops.get_operator(mode, st, dtype=BF16, device=device)
        x, s = cg.cg_solve(op, b_is_ones=True, recompute_ap=False)
        xh = op.from_field(x).double().cpu()
        runs.append((s, float(xh.sum()), float(torch.linalg.vector_norm(xh))))
    (s, sx, nx), (s_cpu, sx_cpu, nx_cpu) = runs
    assert s.converged and s_cpu.converged and abs(s.iterations - s_cpu.iterations) <= 1
    np.testing.assert_allclose((sx, nx), (sx_cpu, nx_cpu), rtol=1e-2)
    if mode == "stencil5-const":
        with pytest.raises(ValueError, match="bf16"):
            cg.cg_solve(ops.get_operator(mode, st, dtype=BF16, device=dev), b_is_ones=True)


# the graph loop's solves against the eager loop's: (mode, dtype, loop); the loops and
# dtypes the graph runs (bf16: the classic loop only, as in the JAX package)
GRAPH_CASES = [("stencil5-const", torch.float32, "recompute"),
               ("stencil5-const", torch.float64, "recompute"),
               ("stencil5-const", torch.float32, "classic"),
               ("stencil5-const", BF16, "classic"),
               ("stencil5", torch.float32, "classic"), ("stencil5", torch.float64, "classic"),
               ("stencil5", BF16, "classic"), ("stencil5-bf16c", torch.float32, "classic"),
               ("csr", torch.float64, "classic"), ("dia", torch.float64, "classic"),
               ("stencil5", torch.float64, "fused"), ("stencil5-const", torch.float64, "fused")]
LOOP_ARGS = {"recompute": {"recompute_ap": True}, "classic": {"recompute_ap": False},
             "fused": {"fused_pupdate": True}}


def _solve_counted(op, *args, **kwargs):
    """cg_solve with the wrappers' and the replays' launch counts and cg.COUNTS reset just
    before it; returns (x, stats, eager launches, replayed launches, counts)."""
    for counter in (st5, blas1, ell, dia, graph_kernels, cg):
        counter.reset_launches()
    cg.reset_counts()
    x, s = cg.cg_solve(op, *args, **kwargs)
    eager = {n: v for c in (st5, blas1, ell, dia, graph_kernels) for n, v in c.LAUNCHES.items()
             if v}
    return x, s, eager, dict(cg.LAUNCHES), dict(cg.COUNTS)


@pytest.mark.parametrize("mode,dtype,loop", GRAPH_CASES)
def test_graph_loop_equals_eager_on_card(dev, mode, dtype, loop):
    """The graph loop (the default) against the eager loop on the same operator at
    g = 256: the same iterations and x bit for bit, one replay and one read a solve (the
    eager loop reads once an iteration and once more), and the replays' launches k times
    one iteration's, the start's (K6) launched eagerly."""
    st = Stencil5(grid_size=256, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator(mode, st, dtype=dtype, device=dev)
    x_e, s_e, _, _, counts_e = _solve_counted(op, b_is_ones=True, graph=False,
                                              **LOOP_ARGS[loop])
    assert counts_e == {"host_reads": s_e.iterations + 2, "replays": 0, "solves": 1,
                        "captures": 0}
    # the capture, then another: the first x is still held while the second solve runs,
    # so it takes a slot of its own (test_torch_cg_graph: a held x keeps its slot)
    for _ in range(2):
        x, s, eager, replayed, counts = _solve_counted(op, b_is_ones=True, **LOOP_ARGS[loop])
        assert s.converged and s.iterations == s_e.iterations
        assert torch.equal(x, x_e)
        assert counts == {"host_reads": 1, "replays": 1, "solves": 1, "captures": 1}
        assert eager == {"dot": 1}
        loop_obj = op.graphs[cg.DeviceLoop.key(op, loop, 1000, 1e-6)]
        per = loop_obj.per_iteration
        assert {n: v for n, v in replayed.items() if n != "cg_cond"} == \
            {n: s.iterations * v for n, v in per.items()}
        assert replayed["cg_cond"] == 1 + cg.UNROLL * -(-s.iterations // cg.UNROLL)
        assert s.residual_norm == s_e.residual_norm


def test_graph_solve_spans_on_card(dev):
    """With recording on, a new operator's first graph solve opens ``CG_Capture`` under
    its ``CG_Slot`` (the slot's graph, the workspace's eager iteration in it); the second,
    the first x dropped, replays that slot and captures nothing."""
    st = Stencil5(grid_size=256, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=torch.float64, device=dev)
    profiling.reset()
    cg.reset_counts()
    with profiling.recording():
        for _ in range(2):
            x, s = cg.cg_solve(op, b_is_ones=True)
            del x
    spans = profiling.spans()
    profiling.reset()
    assert s.converged and cg.COUNTS == {"host_reads": 2, "replays": 2, "solves": 2,
                                         "captures": 1}
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    assert [(spans[i].name, spans[i].solve) for i in roots] == [("CG_Solver", 1),
                                                              ("CG_Solver", 2)]
    for i, captured in zip(roots, (True, False)):
        kids = [j for j, sp in enumerate(spans) if sp.parent == i]
        assert [spans[j].name for j in kids] == ["CG_Slot", "CG_Start", "CG_Replay",
                                                 "CG_Read"]
        under_slot = [sp.name for sp in spans if sp.parent == kids[0]]
        assert under_slot == (["CG_Capture"] if captured else [])


@pytest.mark.parametrize("case", ["zero b", "max_iters 0", "max_iters 1", "max_iters 5",
                                  "seeded x0", "given b"])
@pytest.mark.parametrize("loop", ["recompute", "classic", "fused"])
def test_graph_loop_edge_cases_on_card(dev, case, loop):
    """The JAX loop's edge cases, graph against eager bit for bit: a zero b runs 0
    iterations, max_iters = 0 runs none (the audit's fixed-overhead solve: x = 0,
    unconverged), max_iters = 1 and 5 stop mid-way (unconverged), a seeded x0 is held to
    ‖b‖, and a given b."""
    g = 64
    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=torch.float64, device=dev)
    rng = np.random.RandomState(3)
    b, x0, config = op.ones_b(), None, cg.CGConfig()
    if case == "zero b":
        b = torch.zeros_like(b)
    elif case.startswith("max_iters"):
        config = cg.CGConfig(max_iters=int(case.split()[1]))
    elif case == "seeded x0":
        x0 = torch.from_numpy(rng.randn(g, g)).to(dev)
    else:
        b = torch.from_numpy(rng.rand(g, g)).to(dev)
    runs = [cg.cg_solve(op, b, x0, config=config, graph=graph, **LOOP_ARGS[loop])
            for graph in (False, True)]
    (x_e, s_e), (x, s) = runs
    assert s.iterations == s_e.iterations and s.converged == s_e.converged
    assert torch.equal(x, x_e)
    if case in ("zero b", "max_iters 0"):
        assert s.iterations == 0 and not x.any()
    if case.startswith("max_iters"):
        assert s.iterations == config.max_iters and not s.converged


def test_audit_closes_on_card(dev, tmp_path):
    """audit_cg_iteration at 4096²: every phase launched its kernel in its chains, both
    loops converge, and the phases add up to the measured iteration within 80-120%.
    4096² is the smallest power-of-two grid whose fields (64 MiB) exceed the card's 50 MiB
    L2; at 1024² the phases were 45-85% of the iteration in five runs (chip_smoke.py phase
    12 prints it): the loop's one-element kernels (α, β, rr, k and the condition), which
    no phase times, take a third or more of its ~20-36 µs there."""
    from tpusparse_torch.scripts import audit_cg_iteration

    out = tmp_path / "audit.json"
    assert audit_cg_iteration.main(["--grid=4096", f"--out={out}"]) == 0
    res = json.loads(out.read_text())
    # one eager launch, a warm-up chain of 4, then three chains of 4 and three of 16
    assert all(p["launches"] == 1 + 4 + 3 * (4 + 16) for p in res["phases"].values())
    for loop in ("classic_loop", "recompute_loop"):
        assert res[loop]["iterations"] > 0
        assert 80 <= res[loop]["closure_pct"] <= 120, res[loop]


def test_graph_returned_x_survives_a_later_solve(dev):
    """An x the caller holds is never written by a later solve: the loop captures a second
    slot, and reuses the first once its x is dropped."""
    st = Stencil5(grid_size=128, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device=dev)
    x1, _ = cg.cg_solve(op, b_is_ones=True)
    keep = x1.clone()
    b = torch.from_numpy(np.random.RandomState(5).rand(128, 128)).to(dev)
    x2, _ = cg.cg_solve(op, b)
    (loop,) = op.graphs.values()
    assert torch.equal(x1, keep) and not torch.equal(x2, keep)
    assert len(loop.slots) == 2
    flat = x1.reshape(-1)  # a view keeps the first slot busy
    del x1
    x3, _ = cg.cg_solve(op, b_is_ones=True)
    assert len(loop.slots) == 3 and torch.equal(flat, keep.reshape(-1))
    del flat, x3
    x4, _ = cg.cg_solve(op, b_is_ones=True)
    assert len(loop.slots) == 3 and torch.equal(x4, keep)


def test_graph_memory_is_flat_over_20_solves(dev):
    """20 solves of one operator, each x dropped by the next assignment: device memory
    after the third equals memory after the twentieth (the graph, its pool and its fields
    are made once, and two slots alternate)."""
    st = Stencil5(grid_size=512, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=torch.float64, device=dev)
    used = []
    for _ in range(20):
        x, s = cg.cg_solve(op, b_is_ones=True)
        assert s.converged
        torch.cuda.synchronize()
        used.append(torch.cuda.memory_allocated(dev))
    assert used[2:] == [used[2]] * 18


def test_graph_free_releases_the_graphs(dev):
    """``op.free()`` drops the operator's captured loops, their graphs and fields."""
    st = Stencil5(grid_size=1024, planes=None, constant=(5.0, -1.0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    op = ops.get_operator("stencil5-const", st, dtype=torch.float64, device=dev)
    x, s = cg.cg_solve(op, b_is_ones=True)
    x2, s2 = cg.cg_solve(op, b_is_ones=True, recompute_ap=False)
    assert len(op.graphs) == 2 and s.iterations == s2.iterations
    held = torch.cuda.memory_allocated(dev)
    field = x.numel() * x.element_size()
    assert held - base >= 8 * field  # each loop's x and r, two p; p and Ap
    del x, x2
    op.free()
    torch.cuda.synchronize()
    assert not op.graphs and torch.cuda.memory_allocated(dev) - base < field


def test_graph_refuses_what_it_cannot_capture(dev):
    """graph=True raises where the loop cannot be captured (bcoo, the plain twins, plain
    BLAS1 ops); the default runs those eagerly."""
    st = Stencil5(grid_size=64, planes=None, constant=(5.0, -1.0))
    for mode in ("bcoo", "stencil5-xla", "csr-xla"):
        op = ops.get_operator(mode, st, dtype=torch.float64, device=dev)
        assert not op.captures
        with pytest.raises(ValueError, match="graph=True"):
            cg.cg_solve(op, b_is_ones=True, graph=True)
        cg.reset_counts()
        _, s = cg.cg_solve(op, b_is_ones=True)
        assert s.converged and cg.COUNTS["replays"] == 0 and not op.graphs
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="graph=True"):
        cg.cg_solve(op, b_is_ones=True, graph=True, use_pallas_blas1=False)


def test_graph_cond_kernel_matches_twin(dev):
    """The condition kernel against its twin: an IF node whose body sets a flag, replayed
    for k, max_iters, rr and tol² around the edges (equal, zero, NaN), in f32 and f64."""
    for acc in (torch.float32, torch.float64):
        k = torch.zeros((), dtype=torch.int64, device=dev)
        rr, tol2 = (torch.zeros((), dtype=acc, device=dev) for _ in range(2))
        flag = torch.zeros((), dtype=torch.int32, device=dev)
        graph_kernels.preload(dev)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            with graph_kernels.conditional(graph_kernels.IF, k, 7, rr, tol2):
                flag.fill_(1)
        for kv, rv, tv in [(0, 1.0, 0.5), (6, 1.0, 0.5), (7, 1.0, 0.5), (8, 1.0, 0.5),
                           (0, 0.0, 0.0), (0, 0.5, 0.5), (0, 0.5, 0.25), (0, float("nan"), 0.1),
                           (3, 1e-30, 0.0), (-1, 2.0, 1.0)]:
            k.fill_(kv)
            rr.fill_(rv)
            tol2.fill_(tv)
            flag.zero_()
            g.replay()
            assert bool(flag) == graph_kernels.cond_plain(k, 7, rr, tol2), (acc, kv, rv, tv)


def test_graph_kernels_reach_the_profiler(dev):
    """A replayed solve shows its kernels with their device time under torch.profiler:
    phase 7 of chip_smoke.py splits the graph loop's solves by kernel.  CUPTI reports a
    graph's kernels in full only if it ran when the graph was captured, so a profile
    comes first (as in phase 7)."""
    st = Stencil5(grid_size=256, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    cg.cg_solve(op, b_is_ones=True)  # the capture, outside the profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, s = cg.cg_solve(op, b_is_ones=True)
        torch.cuda.synchronize()
    rows = {e.key: e for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    for kernel in ("spmv_planes_kernel", "cg_update_kernel", "p_update", "cond_kernel"):
        hits = [r for name, r in rows.items() if kernel in name]
        assert hits and sum(r.self_device_time_total for r in hits) > 0, kernel
    assert sum(r.count for name, r in rows.items() if "cg_update_kernel" in name) == \
        s.iterations

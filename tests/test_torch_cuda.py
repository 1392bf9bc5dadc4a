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
and 10^6 elements in f32, f64 and bf16, aligned and offset by one element, and K6 to be bitwise repeatable over 1000 calls and on two streams.
``bcoo`` runs in row bands on the stencil CSR made on the card.  The host-stepped solve
(``cg_solve_stepped``) is held to ``cg_solve``'s iteration count and x (f64 1e-12, f32
1e-5); a probe's chain runs as a CUDA graph, and a chain whose passes allocate a field
raises at its capture; the streaming probe kernels equal their twins; the phase scopes
reach the profiler's events.  The sharded solver runs on one rank against ``cg_solve``,
on two gloo ranks sharing the card and on four as a 2 x 2 mesh of blocks (spawned by
``dist.launch_local``, which imports this module in each rank), its pieces against their
twins: the ELL kernel's rectangular call and K3/K8 on one-row bands written into a larger
y.  The matrices come from the
port's own ``formats`` and ``generate``: this file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpusparse_torch import convert, formats, generate, ops
from tpusparse_torch.bench import probes, profiling
from tpusparse_torch.formats import Stencil5
from tpusparse_torch.kernels import _launch, blas1, dia, ell, stream_probe
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
                            "spmv_stencil5_const": 2, "spmv_stencil5_const_pupdate_dot": 1,
                            "cg_const_update_recompute": 1, "spmv_stencil5_const_pupdate": 1}
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
    x, s = cg.cg_solve(op, b_is_ones=True, fused_pupdate=True)
    fused = ("spmv_stencil5_const_pupdate" if mode == "stencil5-const"
             else "spmv_stencil5_pupdate")
    assert st5.LAUNCHES[fused] == s.iterations
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
    """A profiled classic solve carries the phase names (record_function, with NVTX
    ranges of the same names) and the kernels' names in its trace."""
    import json

    st = Stencil5(grid_size=64, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cg.cg_solve(op, b_is_ones=True)
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
        assert k8 == 3 * iterations and b1["dot"] == 1
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

"""The port's values-carrying stencil against the JAX package: K8's plain twin
(``spmv_stencil5_plain``, which the ``spmv_stencil5`` wrapper runs for CPU tensors), the
device synthesis of the coefficient planes, and the ``stencil5``/``stencil5-bf16c``/
``stencil5-xla`` operators.

The same seeded numpy inputs go through the JAX function, its Pallas kernels run in
interpret mode on the CPU with ``block_rows=8`` (as tests/test_kernels_stencil5.py runs
them), and through the port on CPU tensors.  Tolerance: f64 rtol/atol 1e-12 (the dots sum
in another order).  bf16 planes against f32 planes: equal bit for bit.

The CUDA kernel itself is held against its twin on a card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import carry
from tpusparse import formats, io_mtx
from tpusparse import generate as jgen
from tpusparse import ops as jops
from tpusparse.kernels import stencil5 as jst5
from tpusparse_torch import convert, generate, ops
from tpusparse_torch.kernels import stencil5 as st5

GRIDS = [8, 17, 33]
JKW = {"block_rows": 8, "interpret": True}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


def _planes(seed, rows, g):
    """Random coefficient planes of a real stencil: W is zero on the first column and E
    on the last (the Pallas kernel reads the edge column itself there, so only a zero
    coefficient makes it the matrix's product)."""
    planes = _rand(seed, 5, rows, g)
    planes[formats.W, :, 0] = 0.0
    planes[formats.E, :, -1] = 0.0
    return planes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol=1e-12):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def _jax_spmv(ref, planes, x, hp=None, hn=None, with_dot=False):
    """One of the three JAX formulations of K8, with the dot formed beside the XLA one."""
    args = [jnp.asarray(a) if a is not None else None for a in (planes, x, hp, hn)]
    if ref == "xla":
        y = jst5.spmv_stencil5_xla(*args)
        return (y, jnp.sum(args[1] * y)) if with_dot else y
    fn = jst5.spmv_stencil5_pipelined if ref == "pipelined" else jst5.spmv_stencil5_pallas
    return fn(*args, with_dot=with_dot, **JKW)


@pytest.mark.parametrize("ref", ["pipelined", "pallas", "xla"])
@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("with_dot", [False, True])
def test_spmv_matches_jax(ref, g, with_dot):
    """Random (non-constant) planes over a full grid, f64."""
    planes, x = _planes(g, g, g), _rand(g + 1, g, g)
    want = _jax_spmv(ref, planes, x, with_dot=with_dot)
    got = st5.spmv_stencil5(_t(planes), _t(x), with_dot=with_dot)
    if with_dot:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("ref", ["pipelined", "xla"])
def test_band_with_halo_rows(ref):
    """An interior band of a larger grid: N/S of its edge rows come from halo rows."""
    g, rows = 24, 16
    planes, x = _planes(3, rows, g), _rand(4, rows, g)
    hp, hn = _rand(5, 1, g), _rand(6, 1, g)
    want = _jax_spmv(ref, planes, x, hp, hn, with_dot=True)
    got = st5.spmv_stencil5(_t(planes), _t(x), _t(hp), _t(hn), with_dot=True)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("g", [13, 16, 24])
@pytest.mark.parametrize("beta", [0.0, 0.7])
@pytest.mark.parametrize("halos", [False, True])
@pytest.mark.parametrize("pdt", ["f64", "bf16"])
def test_pupdate_matches_jax(g, beta, halos, pdt):
    """K9's twin (``spmv_stencil5_pupdate``) against ``spmv_stencil5_pupdate_pipelined``
    in interpret mode: p' = r + β·p, y = A·p' and <p', y>, for β = 0 with p = 0 (the first
    iteration) and β = 0.7, on a full grid or a band with halo rows.  f64 planes with f64
    state to 1e-12; bf16 planes with f32 state to 1e-5 (both round each coefficient to bf16
    once, then compute in f32).  p is left as it was."""
    rows = g if not halos else g // 2 + 3
    planes = _planes(g, rows, g)
    rng = np.random.RandomState(g + 5)
    r = rng.randn(rows, g)
    p = np.zeros((rows, g)) if beta == 0.0 else rng.randn(rows, g)
    hs = (rng.randn(1, g), rng.randn(1, g)) if halos else (None, None)
    tol = 1e-12
    if pdt == "bf16":
        r, p = r.astype(np.float32), p.astype(np.float32)
        hs = tuple(h.astype(np.float32) for h in hs) if halos else hs
        jplanes, tplanes = jnp.asarray(planes, jnp.bfloat16), _t(planes).to(torch.bfloat16)
        tol = 1e-5
    else:
        jplanes, tplanes = jnp.asarray(planes), _t(planes)
    want = jst5.spmv_stencil5_pupdate_pipelined(
        jplanes, beta, jnp.asarray(r), jnp.asarray(p),
        *(None if h is None else jnp.asarray(h) for h in hs), **JKW)
    pt = _t(p)
    got = st5.spmv_stencil5_pupdate(tplanes, beta, _t(r), pt,
                                    *(None if h is None else _t(h) for h in hs))
    for a, b in zip(got, want):
        assert a.dtype == pt.dtype
        _close(a, b, tol=tol)
    np.testing.assert_array_equal(pt.numpy(), p)
    pn, y, _ = got
    assert torch.equal(y, st5.spmv_stencil5(tplanes, pn, *(None if h is None else _t(h)
                                                          for h in hs)))


def test_pupdate_out_and_launch_counts():
    """``out`` receives p' and may overlap neither r nor p; the twin counts no launch."""
    st5.reset_launches()
    g = 8
    planes = _t(_planes(1, g, g))
    r, p = _t(_rand(2, g, g)), _t(_rand(3, g, g))
    out = torch.empty_like(p)
    pn, y, d = st5.spmv_stencil5_pupdate(planes, 0.5, r, p, out=out)
    assert pn is out and torch.equal(pn, r + 0.5 * p)
    for bad, name in ((p, "p"), (r, "r")):
        with pytest.raises(ValueError, match=f"overlap {name}"):
            st5.spmv_stencil5_pupdate(planes, 0.5, r, p, out=bad)
    assert st5.LAUNCHES == dict.fromkeys(st5.LAUNCHES, 0)


def test_planes_from_the_mtx_route(tmp_path):
    """A .mtx file through formats.csr_to_stencil5, then the same matrix with two
    coefficients changed (no longer a constant stencil): the operator's SpMV equals the
    dense matrix's and the JAX operator's."""
    g = 12
    path = tmp_path / "g12.mtx"
    jgen.write_matrix_market_stencil5(str(path), g)
    csr = formats.coo_to_csr(io_mtx.load_matrix_market(str(path)))
    planes = formats.csr_to_stencil5(csr).planes.copy()
    planes[formats.C, 3, 4] = 7.25
    planes[formats.E, 5, 0] = -0.5
    x = _rand(7, g, g)
    for mat in (csr, formats.stencil5_to_csr(formats.Stencil5(g, planes))):
        op = ops.get_operator("stencil5", carry(mat), dtype=torch.float64, device="cpu")
        jop = jops.get_operator("stencil5", mat, dtype=jnp.float64)
        y = op.run_device(op.as_field(x.ravel()))
        _close(y, jop.run_device(jnp.asarray(x)))
        _close(op.from_field(y), formats.stencil5_to_csr(formats.Stencil5(g, np.asarray(
            op.planes))).to_dense() @ x.ravel())
    np.testing.assert_array_equal(op.planes.numpy(), planes)


@pytest.mark.parametrize("g", [8, 33])
def test_bf16_planes_equal_f32_planes_bitwise(g):
    """bf16 → f32 is exact, so bf16 planes holding 5/−1/0 give the f32 planes' bits."""
    x = _t(_rand(g, g, g).astype(np.float32))
    p32 = generate.make_stencil5_planes_device(g, dtype=torch.float32, device="cpu")
    p16 = generate.make_stencil5_planes_device(g, dtype=torch.bfloat16, device="cpu")
    y32, d32 = st5.spmv_stencil5(p32, x, with_dot=True)
    y16, d16 = st5.spmv_stencil5(p16, x, with_dot=True)
    assert y16.dtype == torch.float32
    assert torch.equal(y16, y32) and torch.equal(d16, d32)


def test_bf16c_general_planes_round_as_jax():
    """stencil5-bf16c with coefficients that bf16 cannot hold: both packages round each
    one to bf16 once, then compute in f32."""
    g = 16
    planes = _planes(8, g, g)
    st = formats.Stencil5(g, planes)
    x = _rand(9, g, g).astype(np.float32)
    op = ops.get_operator("stencil5-bf16c", carry(st), dtype=torch.float32, device="cpu")
    jop = jops.get_operator("stencil5-bf16c", st, dtype=jnp.float32)
    assert op.planes.dtype == torch.bfloat16
    np.testing.assert_array_equal(op.planes.float().numpy(),
                                  np.asarray(jnp.asarray(planes, jnp.bfloat16), np.float32))
    _close(op.run_device(_t(x)), jop.run_device(jnp.asarray(x)), tol=1e-6)


@pytest.mark.parametrize("g", [1, 2, 9])
@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_planes_synthesis_matches_jax_and_host(g, dtype):
    tdt = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}[dtype]
    jdt = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[dtype]
    got = generate.make_stencil5_planes_device(g, 5.0, -1.0, dtype=tdt, device="cpu")
    assert got.dtype == tdt and got.shape == (5, g, g) and got.is_contiguous()
    got = got.double().numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jgen.make_stencil5_planes_device(g, 5.0, -1.0, dtype=jdt), np.float64))
    np.testing.assert_array_equal(got, jgen.make_stencil5(g, 5.0, -1.0).planes)


def test_planes_from_numpy_copies_and_checks():
    planes = jgen.make_stencil5(6).planes
    t = convert.planes_from_numpy(planes, torch.float64, "cpu")
    assert not np.shares_memory(t.numpy(), planes)
    np.testing.assert_array_equal(t.numpy(), planes)
    assert convert.planes_from_numpy(planes, torch.bfloat16, "cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="planes of shape"):
        convert.planes_from_numpy(planes[:3], torch.float32, "cpu")


def test_operator_holds_and_frees_its_planes():
    st = carry(formats.Stencil5(grid_size=10, planes=None, constant=(5.0, -1.0)))
    op = ops.get_operator("stencil5", st, dtype=torch.float64, device="cpu")
    assert op.planes.shape == (5, 10, 10) and op.planes.dtype == torch.float64
    y, ms = op.run_timed(np.ones(100))
    assert isinstance(y, np.ndarray) and y.shape == (100,) and ms > 0
    np.testing.assert_allclose(y.sum(), jgen.stencil5_spmv_checksums(10)[0], rtol=1e-12)
    yr, _ = op.run_timed_resident(op.ones_b())
    np.testing.assert_array_equal(op.from_field(yr).numpy(), y)
    assert ops.get_operator("stencil5-csr", st, device="cpu").name == "stencil5"
    op.free()
    assert op.planes is None
    with pytest.raises(RuntimeError, match="freed"):
        op.run_device(torch.ones(10, 10, dtype=torch.float64))


def test_plain_twin_does_not_count_launches():
    st5.reset_launches()
    g = 8
    st5.spmv_stencil5(_t(_planes(1, g, g)), _t(_rand(2, g, g)), with_dot=True)
    assert st5.LAUNCHES == dict.fromkeys(st5.LAUNCHES, 0)


def test_non_cpu_tensor_never_reaches_the_twin():
    x = torch.empty((8, 8), dtype=torch.float64, device="meta")
    planes = torch.empty((5, 8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        st5.spmv_stencil5(planes, x)

"""The port's BLAS1 passes (tpusparse_torch.kernels.blas1, K4-K7) against the JAX
package's Pallas kernels (tpusparse/kernels/blas1.py).

The same seeded numpy inputs go through the Pallas kernel, run in interpret mode on the
CPU with ``block_rows=8``, and through the port's wrapper on CPU tensors, which runs its
plain PyTorch twin.  The fields have a row count that is not a multiple of 8, so the
Pallas kernels run a ragged last block.  Tolerances: f64 rtol/atol 1e-12, f32 1e-6 (the
dots sum in another order).

The CUDA kernels themselves are held against their twins on a card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import blas1 as jblas1
from tpusparse_torch.kernels import blas1

SHAPES = [(13, 24), (21, 17)]
DTYPES = {"f64": (np.float64, 1e-12), "f32": (np.float32, 1e-6)}
JKW = {"block_rows": 8, "interpret": True}


def _fields(seed, n, shape, dtype):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_cg_update_matches_pallas(shape, dt):
    dtype, tol = DTYPES[dt]
    x, r, p, ap = _fields(shape[0], 4, shape, dtype)
    xj, rj, rrj = jblas1.cg_update_pallas(0.37, *map(jnp.asarray, (x, r, p, ap)), **JKW)
    xt, rt = _t(x), _t(r)
    xo, ro, rr = blas1.cg_update(0.37, xt, rt, _t(p), _t(ap))
    assert xo is xt and ro is rt  # in place, as the kernel updates them
    assert rr.dtype == xt.dtype and rr.shape == ()
    for got, want in ((xo, xj), (ro, rj), (rr, rrj)):
        _close(got, want, tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_p_update_matches_pallas(shape, dt):
    dtype, tol = DTYPES[dt]
    r, p = _fields(shape[1], 2, shape, dtype)
    pj = jblas1.p_update_pallas(0.7, jnp.asarray(r), jnp.asarray(p), **JKW)
    pt = _t(p)
    assert blas1.p_update(0.7, _t(r), pt) is pt  # in place
    _close(pt, pj, tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_dot_matches_pallas(shape, dt):
    dtype, tol = DTYPES[dt]
    a, b = _fields(7, 2, shape, dtype)
    want = jblas1.dot_pallas(jnp.asarray(a), jnp.asarray(b), **JKW)
    got = blas1.dot(_t(a), _t(b))
    assert got.dtype == torch.from_numpy(a).dtype
    _close(got, want, tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_axpby_dot_matches_pallas(shape, dt):
    dtype, tol = DTYPES[dt]
    x, y = _fields(11, 2, shape, dtype)
    zj, zzj = jblas1.axpby_dot_pallas(1.0, jnp.asarray(x), -1.0, jnp.asarray(y), **JKW)
    xt, yt = _t(x), _t(y)
    z, zz = blas1.axpby_dot(1.0, xt, -1.0, yt)
    assert z is not xt and z is not yt  # z gets its own buffer
    _close(z, zj, tol)
    _close(zz, zzj, tol)
    # r0 = 1·b + (−1)·A·x0 is exactly b − A·x0
    assert torch.equal(z, xt - yt)
    z2, _ = blas1.axpby_dot(0.3, xt, 1.7, yt)
    _close(z2, jblas1.axpby_dot_pallas(0.3, jnp.asarray(x), 1.7, jnp.asarray(y), **JKW)[0],
           tol)


def test_twins_round_as_the_plain_updates():
    """The twins change no bits against the plain-PyTorch updates the classic loop ran
    before the kernels: x + α·p, r − α·Ap, r + β·p."""
    x, r, p, ap = (_t(a) for a in _fields(3, 4, (9, 9), np.float32))
    alpha, beta = torch.tensor(0.37, dtype=torch.float32), torch.tensor(0.7, dtype=torch.float32)
    x_want, r_want = x + alpha * p, r - alpha * ap
    p_want = r_want + beta * p
    xo, ro, rr = blas1.cg_update(alpha, x.clone(), r.clone(), p, ap)
    assert torch.equal(xo, x_want) and torch.equal(ro, r_want)
    assert torch.equal(rr, torch.dot(r_want.reshape(-1), r_want.reshape(-1)))
    assert torch.equal(blas1.p_update(beta, ro, p.clone()), p_want)


def test_in_place_updates_refuse_overlap():
    """In the JAX loop p *is* r on the first iteration; an in-place K4 would then read a
    p it has already overwritten.  Kernel and twin both refuse."""
    x, r, p = (_t(a) for a in _fields(4, 3, (8, 8), np.float64))
    with pytest.raises(ValueError, match="r must not overlap p"):
        blas1.cg_update(0.5, x, r, r, p)
    with pytest.raises(ValueError, match="x must not overlap ap"):
        blas1.cg_update(0.5, x, r, p, x[:4])
    with pytest.raises(ValueError, match="x must not overlap r"):
        blas1.cg_update(0.5, x, x, p, p)
    with pytest.raises(ValueError, match="p must not overlap r"):
        blas1.p_update(0.5, p, p)


def test_plain_twins_do_not_count_launches():
    blas1.reset_launches()
    x, r, p, ap = (_t(a) for a in _fields(5, 4, (8, 8), np.float64))
    blas1.cg_update(0.5, x, r, p, ap)
    blas1.p_update(0.5, r, p)
    blas1.dot(x, r)
    blas1.axpby_dot(1.0, x, -1.0, r)
    assert blas1.LAUNCHES == dict.fromkeys(blas1.LAUNCHES, 0)


def test_non_cpu_tensor_never_reaches_the_twin():
    """Only CPU tensors take the plain twin; any other device goes to the kernel path,
    which accepts CUDA tensors alone."""
    x, r, p, ap = (torch.empty((8, 8), dtype=torch.float64, device="meta") for _ in range(4))
    for call in (lambda: blas1.cg_update(0.5, x, r, p, ap), lambda: blas1.p_update(0.5, r, p),
                 lambda: blas1.dot(x, r), lambda: blas1.axpby_dot(1.0, x, -1.0, r)):
        with pytest.raises(ValueError, match="CUDA"):
            call()

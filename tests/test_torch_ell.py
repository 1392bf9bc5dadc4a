"""The port's ELL SpMV against the JAX package's gather kernels.

``spmv_ell_plain`` (the twin of the CUDA kernel that replaces K12/K13, which the
``spmv_ell`` wrapper runs for CPU tensors) on the slot-major operand of
``convert.ell_from_numpy``, against:

- the JAX Pallas kernels ``spmv_gather_ell`` (ladder pack, K12) and ``spmv_gather_affine``
  (affine pack, K13), in interpret mode, on the matrices each pack takes;
- the JAX operators ``csr`` and ``csr-xla`` (the XLA gather, whose port the twin is), with
  the fused dot, on matrices neither pack takes too: heavy unbalanced rows and uniformly
  random columns.

Matrices come from ``tests/fixtures.py`` and ``tests/test_kernels_gather.py``'s random
banded generator; x from a seeded numpy generator.  Tolerance: f64 1e-12 (the overflow
scatter-add of the JAX packs sums in another order).  The device synthesis of the
stencil's ELL must equal the host pack bit for bit.

The CUDA kernel itself is held against its twin on a card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_kernels_gather import _random_banded_csr
from tpusparse import formats
from tpusparse import ops as jops
from tpusparse.kernels import gather_ell as jgell
from tpusparse_torch import convert, generate, ops
from tpusparse_torch.kernels import ell

MATRICES = {
    "identity": lambda: fixtures.identity(40),
    "tridiagonal": lambda: fixtures.tridiagonal(300),
    "banded": lambda: fixtures.banded(257, 5),
    "diagonal": lambda: fixtures.diagonal(np.arange(1.0, 130.0)),
    "spd_stencil": lambda: fixtures.spd_stencil_csr(13),
    "random_banded": lambda: _random_banded_csr(500, 9, 4, seed=500),
    "random_banded_wide": lambda: _random_banded_csr(1500, 300, 7, seed=1500),
    "unbalanced_rows": lambda: fixtures.unbalanced_rows(400),
}


def _scattered(n=3000):
    """Each row hits 3 uniformly random columns: no column window survives
    (tests/test_kernels_gather.py's case that the JAX pack refuses)."""
    rng = np.random.RandomState(7)
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    cols = rng.randint(0, n, size=3 * n).astype(np.int64)
    return formats.coo_to_csr(formats.COOMatrix(n, n, rows, cols, rng.randn(3 * n)))


def _twin(csr, x):
    e = formats.csr_to_ell(csr)
    vals, cols = convert.ell_from_numpy(e.col, e.val, torch.float64, "cpu")
    return ell.spmv_ell_plain(vals, cols, torch.from_numpy(x)).numpy()


def _jax_kernel(pack, spmv, csr, x):
    e = formats.csr_to_ell(csr)
    op = pack(e.col, e.val, e.num_cols, jnp.float64)
    x128 = np.zeros(op.x_rows * jgell.LANES)
    x128[: csr.num_rows] = x
    y = spmv(op, jnp.asarray(x128.reshape(-1, jgell.LANES)), interpret=True)
    return np.asarray(y).reshape(-1)[: csr.num_rows]


# (matrix, JAX pack): the affine pack refuses random and unbalanced sparsity, the ladder
# pack unbalanced rows; interpret-mode affine costs seconds per matrix, so it runs on the
# narrow ones
KERNEL_CASES = [(m, "ladder") for m in MATRICES if m != "unbalanced_rows"] + [
    (m, "affine") for m in ("identity", "tridiagonal", "diagonal")]
PACKS = {"ladder": (jgell.pack_gather_ell, jgell.spmv_gather_ell),
         "affine": (jgell.pack_gather_ell_affine, jgell.spmv_gather_affine)}


@pytest.mark.parametrize("name,pack", KERNEL_CASES)
def test_twin_matches_jax_gather_kernels(name, pack):
    csr = MATRICES[name]()
    x = np.random.RandomState(1).randn(csr.num_rows)
    want = _jax_kernel(*PACKS[pack], csr, x)
    np.testing.assert_allclose(_twin(csr, x), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(want, csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["unbalanced_rows", "scattered"])
def test_packs_refuse_what_the_twin_takes(name):
    """The JAX packs refuse these matrices (the JAX csr operator then falls back to the
    XLA gather); the port has no fallback: one kernel, one twin, every sparsity."""
    csr = _scattered() if name == "scattered" else MATRICES[name]()
    e = formats.csr_to_ell(csr)
    for pack in (jgell.pack_gather_ell_affine, lambda *a: jgell.pack_gather_ell(
            *a, span_limit=4)):
        with pytest.raises(jgell.GatherPackError):
            pack(e.col, e.val, e.num_cols, jnp.float64)
    x = np.random.RandomState(8).randn(csr.num_rows)
    np.testing.assert_allclose(_twin(csr, x), csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jmode", ["csr", "csr-xla"])
@pytest.mark.parametrize("name", ["unbalanced_rows", "scattered"])
def test_operator_matches_jax_operator(name, jmode):
    """The port's csr operator (the twin on the CPU) and csr-xla against the JAX
    operator: y and the fused dot."""
    csr = _scattered() if name == "scattered" else MATRICES[name]()
    x = np.random.RandomState(2).randn(csr.num_rows)
    jop = jops.get_operator(jmode, csr, dtype=jnp.float64)
    yj, dj = jop.run_device_dot(jop.as_field(x).astype(jnp.float64))
    for mode in ("csr", "csr-xla"):
        op = ops.get_operator(mode, csr, dtype=torch.float64, device="cpu")
        y, d = op.run_device_dot(op.as_field(x))
        assert y.shape == (csr.num_rows,)
        np.testing.assert_allclose(op.from_field(y).numpy(),
                                   np.asarray(jop.from_field(yj)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(d), float(dj), rtol=1e-12)


@pytest.mark.parametrize("g", [3, 8, 17, 33])
def test_device_ell_equals_host_pack(g):
    """make_stencil5_ell_device against formats.stencil5_to_ell (its analytic path),
    bit for bit: columns, pad-with-the-last-real-column slots, and values (float32 on the
    host, exact in f64)."""
    for (d, o) in ((5.0, -1.0), (4.0, -0.3)):
        host = formats.stencil5_to_ell(formats.Stencil5(g, None, (d, o)))
        for dtype in (torch.float32, torch.float64):
            vals, cols = generate.make_stencil5_ell_device(g, d, o, dtype=dtype, device="cpu")
            assert cols.dtype == torch.int32 and vals.dtype == dtype
            assert np.array_equal(cols.numpy(), host.col.T)
            assert np.array_equal(vals.numpy(), host.val.T.astype(vals.numpy().dtype))
    with pytest.raises(ValueError, match="g >= 3"):
        generate.make_stencil5_ell_device(2, device="cpu")


def test_ell_from_numpy_is_slot_major_int32():
    csr = fixtures.unbalanced_rows(100)
    e = formats.csr_to_ell(csr)
    vals, cols = convert.ell_from_numpy(e.col, e.val, torch.float32, "cpu")
    assert vals.shape == cols.shape == (e.width, 100) and vals.is_contiguous()
    assert cols.dtype == torch.int32 and vals.dtype == torch.float32
    assert np.array_equal(cols[3].numpy(), e.col[:, 3])
    with pytest.raises(ValueError, match="int32"):
        convert.ell_from_numpy(e.col + 2 ** 31, e.val, device="cpu")


def test_width_one_empty_rows_and_the_dot():
    """A width-1 diagonal, and rows with no entry (their slots hold value 0 at column
    i), with the fused dot; a non-square matrix is refused."""
    n = 700
    d = np.linspace(1.0, 2.0, n)
    d[::7] = 0.0
    keep = d != 0.0
    i = np.arange(n, dtype=np.int64)[keep]
    csr = formats.coo_to_csr(formats.COOMatrix(n, n, i, i, d[keep]))
    op = ops.get_operator("csr", csr, dtype=torch.float64, device="cpu")
    assert op.operand["cols"].shape == (1, n)
    x = np.random.RandomState(3).randn(n)
    y, dot = op.run_device_dot(op.as_field(x))
    np.testing.assert_array_equal(y.numpy(), d * x)
    np.testing.assert_allclose(float(dot), float(x @ (d * x)), rtol=1e-13)
    rect = formats.coo_to_csr(formats.COOMatrix(3, 4, np.arange(3), np.arange(3),
                                                np.ones(3)))
    for mode in ("csr", "dia", "bcoo"):
        with pytest.raises(ValueError, match="share one field"):
            ops.get_operator(mode, rect, device="cpu")

"""The port's DIA SpMV against the JAX package's DIA kernel (K11).

``spmv_dia_plain`` (the twin of the CUDA kernel that replaces K11, which the ``spmv_dia``
wrapper runs for CPU tensors) on the operand of ``convert.dia_from_numpy``, against the
JAX Pallas kernel ``spmv_dia_pallas`` in interpret mode with ``block_rows128=8`` (as
tests/test_kernels_dia.py runs it), and against the JAX operators ``dia`` and
``dia-xla`` with the fused dot.  Matrices from ``tests/fixtures.py`` and the large-offset
case of tests/test_kernels_dia.py; x from a seeded numpy generator.  Tolerance: f64 1e-12.
The device synthesis of the stencil's DIA must equal the host pack bit for bit.

The CUDA kernel itself is held against its twin on a card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_torch_host import carry
from tpusparse import formats
from tpusparse import ops as jops
from tpusparse.kernels import dia as jdia
from tpusparse_torch import convert, generate, ops
from tpusparse_torch.kernels import dia


def _large_offsets(n=600):
    """The diagonal and one at +300 (tests/test_kernels_dia.py): the offset spans more than
    two 128-lane rows of the JAX layout."""
    rows = np.concatenate([np.arange(n), np.arange(n - 300)]).astype(np.int64)
    cols = np.concatenate([np.arange(n), np.arange(300, n)]).astype(np.int64)
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 300, -0.5)])
    return formats.coo_to_csr(formats.COOMatrix(n, n, rows, cols, vals))


MATRICES = {
    "identity": lambda: fixtures.identity(40),
    "tridiagonal": lambda: fixtures.tridiagonal(300),
    "banded": lambda: fixtures.banded(257, 5),
    "diagonal": lambda: fixtures.diagonal(np.arange(1.0, 130.0)),
    "spd_stencil_13": lambda: fixtures.spd_stencil_csr(13),
    "spd_stencil_24": lambda: fixtures.spd_stencil_csr(24),
    "large_offsets": _large_offsets,
}


def _twin(csr, x):
    d = formats.csr_to_dia(csr)
    data, offsets = convert.dia_from_numpy(d.data, d.offsets, torch.float64, "cpu")
    return dia.spmv_dia_plain(data, offsets, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", list(MATRICES))
def test_twin_matches_jax_dia_kernel(name):
    csr = MATRICES[name]()
    x = np.random.RandomState(1).randn(csr.num_rows)
    data128, offsets, n, nr = jdia.pack_dia_operand(formats.csr_to_dia(csr), jnp.float64)
    want = jdia.spmv_dia_pallas(data128, jdia.x_to_lanes(jnp.asarray(x), nr),
                                offsets=offsets, block_rows128=8, interpret=True)
    want = np.asarray(want).reshape(-1)[:n]
    np.testing.assert_allclose(_twin(csr, x), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(want, csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jmode", ["dia", "dia-xla"])
@pytest.mark.parametrize("name", ["banded", "large_offsets", "stencil_17"])
def test_operator_matches_jax_operator(name, jmode):
    """The port's dia (the twin on the CPU) and dia-xla operators against the JAX
    operator: y and the fused dot; the stencil through its planes-free form (``gen:17``),
    which the port makes on the device and the JAX package packs on the host."""
    mat = (formats.Stencil5(17, None, (5.0, -1.0)) if name == "stencil_17"
           else MATRICES[name]())
    x = np.random.RandomState(2).randn(mat.num_rows)
    jop = jops.get_operator(jmode, mat, dtype=jnp.float64)
    yj, dj = jop.run_device_dot(jop.as_field(x).astype(jnp.float64))
    for mode in ("dia", "dia-xla"):
        op = ops.get_operator(mode, carry(mat), dtype=torch.float64, device="cpu")
        assert op.nnz == jop.nnz and op.num_rows == jop.num_rows
        y, d = op.run_device_dot(op.as_field(x))
        np.testing.assert_allclose(op.from_field(y).numpy(),
                                   np.asarray(jop.from_field(yj)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(d), float(dj), rtol=1e-12)


@pytest.mark.parametrize("g", [2, 3, 8, 17])
def test_device_dia_equals_host_pack(g):
    for (d, o) in ((5.0, -1.0), (4.0, -0.3)):
        host = formats.stencil5_to_dia(formats.Stencil5(g, None, (d, o)))
        for dtype in (torch.float32, torch.float64):
            data, offsets = generate.make_stencil5_dia_device(g, d, o, dtype=dtype,
                                                              device="cpu")
            want_data, want_off = convert.dia_from_numpy(host.data, host.offsets, dtype, "cpu")
            assert torch.equal(offsets, want_off) and offsets.dtype == torch.int64
            assert data.dtype == dtype and torch.equal(data, want_data)
    with pytest.raises(ValueError, match="g >= 2"):
        generate.make_stencil5_dia_device(1, device="cpu")


def test_reads_off_the_matrix_are_selected_out():
    """Where a diagonal leaves the matrix its data never meets x: NaN stored there does not
    reach y (a product with a padded zero would carry it)."""
    n = 1000
    offsets = np.array([-n + 1, -300, -1, 0, 1, 300, n - 1])
    rng = np.random.RandomState(4)
    data = rng.randn(len(offsets), n)
    x = torch.from_numpy(rng.randn(n))
    clean = data.copy()
    for d, off in enumerate(offsets):
        outside = (np.arange(n) + off < 0) | (np.arange(n) + off >= n)
        data[d, outside] = np.nan
        clean[d, outside] = 0.0
    y, dot = dia.spmv_dia(*convert.dia_from_numpy(data, offsets, torch.float64, "cpu"), x,
                          with_dot=True)
    want = dia.spmv_dia(*convert.dia_from_numpy(clean, offsets, torch.float64, "cpu"), x)
    assert torch.isfinite(y).all() and torch.equal(y, want)
    np.testing.assert_allclose(float(dot), float(x @ want), rtol=1e-13)

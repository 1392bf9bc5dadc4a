"""The port's ``bcoo`` operator in row bands, and the stencil CSR it builds on the device.

- ``generate.make_stencil5_csr_device`` on the CPU against the port's host CSR
  (``formats.stencil5_to_csr``), array for array, bit for bit.
- ``ops._init_bcoo`` with the band limit (``ops.BCOO_BAND_ENTRIES``) lowered to 1 entry,
  50, 1000 and left at its default: every row inside one band, the bands in order, each
  within the limit unless it is one row; y equal to the one-band y bit for bit (the CPU's
  product sums each row in entry order), and to the JAX package's ``bcoo`` operator
  (``jax.experimental.sparse``) to 1e-12 in f64.
- CG over banded ``bcoo``: the JAX solve's iteration count, x to 1e-10.

Matrices: ``gen:17``, ``tests/fixtures.tridiagonal(300)``, the same with one row of 120
entries and two empty rows (a row longer than 50 gets a band of its own), and the SPD
banded matrix of ``tests/test_torch_cg.py``.  x from a seeded numpy generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_torch_cg import _spd_banded
from tests.test_torch_host import carry
from tpusparse import formats as jformats
from tpusparse import ops as jops
from tpusparse.solvers import cg as jcg
from tpusparse_torch import formats, generate, ops
from tpusparse_torch.solvers import cg

DEFAULT_LIMIT = ops.BCOO_BAND_ENTRIES
LIMITS = [1, 50, 1000, DEFAULT_LIMIT]


@pytest.mark.parametrize("g", [3, 4, 17, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_csr_equals_host_csr(g, dtype):
    """Row pointers, columns (ascending N, W, C, E, S) and values (rounded through f32);
    a zero coefficient drops its entries as the host CSR does."""
    for d, o in ((5.0, -1.0), (4.0, 0.0), (0.0, -0.3)):
        host = formats.stencil5_to_csr(formats.Stencil5(g, None, (d, o)))
        # a small chunk, so that chunks split grid rows
        row_ptr, col, val = generate.make_stencil5_csr_device(g, d, o, dtype=dtype,
                                                              device="cpu", chunk_points=7)
        assert row_ptr.dtype == col.dtype == torch.int32 and val.dtype == dtype
        assert np.array_equal(row_ptr.numpy(), host.row_ptr)
        assert np.array_equal(col.numpy(), host.col_idx)
        assert np.array_equal(val.numpy(), host.val.astype(val.numpy().dtype))


def test_device_csr_refuses_more_entries_than_int32_holds():
    # 5·g² − 4g passes 2^31 at g = 20725; refused before anything is allocated
    with pytest.raises(ValueError, match="int32"):
        generate.make_stencil5_csr_device(20725, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        generate.make_stencil5_csr_device(0, device="cpu")


def _long_row_csr():
    """tridiagonal(300) with row 150 holding 120 entries and rows 7 and 8 empty."""
    csr = fixtures.tridiagonal(300)
    dense = csr.to_dense()
    dense[150, 60:180] = np.linspace(-1.0, 1.0, 120)
    dense[7:9] = 0.0
    r, c = np.nonzero(dense)
    return jformats.coo_to_csr(jformats.COOMatrix(300, 300, r.astype(np.int64),
                                                  c.astype(np.int64), dense[r, c]))


MATRICES = {
    "gen_17": lambda: jformats.Stencil5(grid_size=17, planes=None, constant=(5.0, -1.0)),
    "tridiagonal": lambda: fixtures.tridiagonal(300),
    "long_row_empty_rows": _long_row_csr,
}


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_bands_give_the_one_band_y(monkeypatch, name, limit):
    mat = MATRICES[name]()
    n = mat.num_rows
    x = np.random.RandomState(5).randn(n)
    one = ops.get_operator("bcoo", carry(mat), dtype=torch.float64, device="cpu")
    assert len(one.operand["bands"]) == 1
    y_one = one.run_device(one.as_field(x))

    monkeypatch.setattr(ops, "BCOO_BAND_ENTRIES", limit)
    op = ops.get_operator("bcoo", carry(mat), dtype=torch.float64, device="cpu")
    row_ptr = op.operand["row_ptr"]
    bands = op.operand["bands"]
    assert [b[0] for b in bands] == [0] + [b[1] for b in bands[:-1]] and bands[-1][1] == n
    for r0, r1, a in bands:
        entries = int(row_ptr[r1] - row_ptr[r0])
        assert entries <= limit or r1 - r0 == 1
        assert a.shape == (r1 - r0, n) and a.crow_indices()[0] == 0
        assert a.crow_indices().dtype == a.col_indices().dtype == torch.int32
        if entries:  # a view of the full columns (an empty one has no storage)
            assert a.col_indices().data_ptr() == op.operand["col"][int(row_ptr[r0]):].data_ptr()
    if limit < 50 or name == "long_row_empty_rows" and limit == 50:
        assert len(bands) > 2
    y, d = op.run_device_dot(op.as_field(x))
    assert torch.equal(y, y_one)

    jop = jops.get_operator("bcoo", mat, dtype=jnp.float64)
    yj, dj = jop.run_device_dot(jop.as_field(x).astype(jnp.float64))
    np.testing.assert_allclose(y.numpy(), np.asarray(jop.from_field(yj)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(float(d), float(dj), rtol=1e-12)


@pytest.mark.parametrize("limit", [1, 50, DEFAULT_LIMIT])
@pytest.mark.parametrize("matrix", ["gen_17", "spd_banded"])
def test_cg_on_bands_matches_jax(monkeypatch, matrix, limit):
    mat = MATRICES["gen_17"]() if matrix == "gen_17" else _spd_banded()
    n = mat.num_rows
    jop = jops.get_operator("bcoo", mat, dtype=jnp.float64)
    xj, sj = jcg.cg_solve(jop, jop.as_field(np.ones(n)).astype(jnp.float64))
    monkeypatch.setattr(ops, "BCOO_BAND_ENTRIES", limit)
    op = ops.get_operator("bcoo", carry(mat), dtype=torch.float64, device="cpu")
    x, s = cg.cg_solve(op, b_is_ones=True)
    assert s.converged and sj.converged
    assert s.iterations == sj.iterations, (s.iterations, sj.iterations)
    np.testing.assert_allclose(op.from_field(x).numpy(), np.asarray(jop.from_field(xj)),
                               rtol=1e-10, atol=1e-12)

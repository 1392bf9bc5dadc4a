"""The band operands of the sharded solver (tpusparse_torch.generate): a rank's rows of the
stencil's coefficient planes, of its slot-major ELL operand and of b = ones, with zero pad
rows, against the same rows of the whole-grid operands.

Whole-grid operands: the port's own, already held to the JAX package's
(tests/test_torch_host.py, tests/test_torch_ell.py); the pad rows: zero planes, zero ELL
values with every column at the point itself, zero b, as the JAX package's sharded solver
padded them (``cg_sharded.py:262-265``, ``:306-310``, ``:406-412``).
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import generate

# (g, lo, hi, pad rows): whole grid, first row, last rows with padding, interior, a band of
# pad rows only, a band that is the grid's first and last row
BANDS = [(16, 0, 16, 0), (16, 0, 1, 0), (16, 14, 16, 2), (16, 3, 9, 0), (10, 10, 10, 3),
         (3, 0, 3, 1), (7, 2, 5, 0)]


@pytest.mark.parametrize("g,lo,hi,pad", BANDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_band_planes_are_the_grids_rows(g, lo, hi, pad, dtype):
    whole = generate.make_stencil5_planes_device(g, dtype=dtype, device="cpu")
    band = generate.make_stencil5_planes_device(g, dtype=dtype, device="cpu", rows=(lo, hi),
                                                pad_rows=pad)
    assert band.shape == (5, hi - lo + pad, g) and band.dtype == dtype
    assert torch.equal(band[:, :hi - lo], whole[:, lo:hi])
    assert not band[:, hi - lo:].any()


@pytest.mark.parametrize("g,lo,hi,pad", BANDS)
def test_band_ell_is_the_grids_rows(g, lo, hi, pad):
    vals, cols = generate.make_stencil5_ell_device(g, dtype=torch.float64, device="cpu")
    bvals, bcols = generate.make_stencil5_ell_device(g, dtype=torch.float64, device="cpu",
                                                     rows=(lo, hi), pad_rows=pad)
    real = (hi - lo) * g
    assert bvals.shape == bcols.shape == (5, (hi - lo + pad) * g)
    assert bcols.dtype == torch.int32
    assert torch.equal(bvals[:, :real], vals[:, lo * g:hi * g])
    assert torch.equal(bcols[:, :real], cols[:, lo * g:hi * g])  # columns stay global
    assert not bvals[:, real:].any()
    points = torch.arange(hi * g, (hi + pad) * g, dtype=torch.int32)
    assert torch.equal(bcols[:, real:], points.expand(5, -1))


@pytest.mark.parametrize("g,lo,hi,pad", BANDS)
def test_ones_band(g, lo, hi, pad):
    b = generate.ones_band(g, (lo, hi), pad, dtype=torch.float64, device="cpu")
    want = np.concatenate([np.ones((hi - lo, g)), np.zeros((pad, g))])
    np.testing.assert_array_equal(b.numpy(), want)


def test_bands_refuse_rows_outside_the_grid():
    for rows, pad in (((3, 2), 0), ((0, 17), 0), ((-1, 4), 0), ((0, 4), -1)):
        with pytest.raises(ValueError, match="do not fit"):
            generate.make_stencil5_planes_device(16, device="cpu", rows=rows, pad_rows=pad)
        with pytest.raises(ValueError, match="do not fit"):
            generate.ones_band(16, rows, pad, device="cpu")

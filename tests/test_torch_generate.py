"""The band operands of the sharded solver (tpusparse_torch.generate): a rank's rows of the
stencil's coefficient planes, of its slot-major ELL operand and of b = ones, with zero pad
rows, and a 2-D block's rows and columns of the planes and of b = ones, against the same
rows and columns of the whole-grid operands.

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


# (g, rows, cols): a 2 x 2 mesh's four blocks, a 1 x 4 mesh's inner block, a block one
# column wide at each side and one in the middle
BLOCKS = [(8, (0, 4), (0, 4)), (8, (0, 4), (4, 8)), (8, (4, 8), (0, 4)), (8, (4, 8), (4, 8)),
          (12, (0, 12), (3, 6)), (6, (2, 4), (0, 1)), (6, (2, 4), (5, 6)), (6, (0, 6), (3, 4))]


@pytest.mark.parametrize("g,rows,cols", BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_block_planes_are_the_grids_block(g, rows, cols, dtype):
    """A block's planes are the whole grid's at its rows and columns: W masked only in
    global column 0, E only in column g − 1 (an inner side column keeps its −1)."""
    whole = generate.make_stencil5_planes_device(g, dtype=dtype, device="cpu")
    block = generate.make_stencil5_planes_device(g, dtype=dtype, device="cpu", rows=rows,
                                                 cols=cols)
    assert block.shape == (5, rows[1] - rows[0], cols[1] - cols[0]) and block.dtype == dtype
    assert torch.equal(block, whole[:, rows[0]:rows[1], cols[0]:cols[1]])


@pytest.mark.parametrize("g,rows,cols", BLOCKS)
def test_ones_block(g, rows, cols):
    b = generate.ones_band(g, rows, dtype=torch.float64, device="cpu", cols=cols)
    np.testing.assert_array_equal(b.numpy(), np.ones((rows[1] - rows[0], cols[1] - cols[0])))


def test_bands_refuse_rows_outside_the_grid():
    for rows, pad in (((3, 2), 0), ((0, 17), 0), ((-1, 4), 0), ((0, 4), -1)):
        with pytest.raises(ValueError, match="do not fit"):
            generate.make_stencil5_planes_device(16, device="cpu", rows=rows, pad_rows=pad)
        with pytest.raises(ValueError, match="do not fit"):
            generate.ones_band(16, rows, pad, device="cpu")
    for cols in ((3, 2), (0, 17), (-1, 4)):
        with pytest.raises(ValueError, match="do not fit"):
            generate.make_stencil5_planes_device(16, device="cpu", cols=cols)
        with pytest.raises(ValueError, match="do not fit"):
            generate.ones_band(16, device="cpu", cols=cols)

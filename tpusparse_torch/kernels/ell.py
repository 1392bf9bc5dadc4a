"""General-sparsity SpMV over a slot-major ELL operand: the CUDA kernel and its plain twin.

Counterpart of ``tpusparse/kernels/gather_ell.py``.  One wrapper backs both of its Pallas
kernels, which compute the same function:

  ``spmv_ell``  K12 ``_spmv_gather_jit`` (ladder pack) and K13 ``_spmv_affine_jit``
                (affine pack): y = A·x, optionally <x, A·x>

The operand is ``formats.csr_to_ell``'s, slot-major: ``vals`` (W, n) in the state's
dtype and ``cols`` (W, n) int32, column k of row i at [k, i] (``convert.ell_from_numpy``,
or ``generate.make_stencil5_ell_device``).  y[i] = Σ_k vals[k, i]·x[cols[k, i]], summed
from 0 over k = 0..W-1 in order; a bf16 state sums the products in f32 (a product of two
bf16 values is exact there) and rounds y to bf16 once, as the JAX kernel computes it
(``_launch``'s contract).  A square matrix takes x of n elements, of any shape, and
gives y of x's shape.  The rectangular call takes x of m > n elements and gives y of n:
the sharded solver's band of rows over its gather domain, the band with a halo row on
either side (``solvers.cg_sharded``); its dot is <x[dot_offset : dot_offset + n], y>, the
band's own rows of x.  None of the JAX package's packs is needed: not the column
windows, the select ladder, the affine and rot packs or the overflow scatter-add, which
answered Mosaic's lane-only gather, nor its fallback to the XLA gather for scattered
columns.  The kernel takes every sparsity.

``spmv_ell_plain`` is the twin, and the port of the XLA gather (``ops._init_ell_xla``,
modes ``csr-xla`` and ``ell``).  A wrapper given a CPU field runs the twin; given a CUDA
field it launches the kernel of ``tpusparse_torch/csrc/ell.cu`` or raises; there is no
fallback between the two.  Kernel and twin round every operation alike, so their y agree
bit for bit; the dots differ only in summation order.

``LAUNCHES["spmv_ell"]`` counts the kernel's launches (the twin does not count), and
``LAUNCHES["spmv_ell_w<W>"]`` those at ELL width W (``spmv_ell_w5`` for the 5-point
stencil, ``spmv_ell_w27`` for HPCG's 27-point one), each made at its width's first launch.
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import acc_dtype
from ._launch import (SUFFIX, check_field, counter, dot_buffers, ptr, row_out, row_partials,
                      stream)
from .blas1 import dot_plain

LAUNCHES = counter(("spmv_ell",))


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES["spmv_ell"] = 0


def spmv_ell_plain(vals, cols, x, *, with_dot=False, dot_offset=0, out=None):
    """Plain twin of ``spmv_ell``: one gather and one multiply-add per slot, in
    ``acc_dtype``, and y rounded to x's dtype once: a bf16 state's products (exact in f32)
    are summed in f32, as the JAX kernel accumulates; f32 and f64 compute in the state's
    dtype."""
    xf = x.reshape(-1)
    acc = acc_dtype(xf.dtype)
    n = vals.shape[1]
    y = xf.new_zeros(n, dtype=acc)
    for k in range(vals.shape[0]):
        y.add_(vals[k].to(acc) * xf.index_select(0, cols[k]).to(acc))
    y = y.to(xf.dtype)
    if n == xf.numel():
        y = y.reshape(x.shape)
    if out is not None:
        y = out.copy_(y)
    return (y, dot_plain(xf[dot_offset:dot_offset + n], y)) if with_dot else y


def spmv_ell(vals, cols, x, *, with_dot=False, dot_offset=0, out=None):
    """y = A·x for the slot-major ELL operand (vals, cols) of n rows, or (y, <x[dot_offset
    : dot_offset + n], y>) when ``with_dot``.  x holds m >= n elements; y has x's shape
    when m == n, else (n,); it goes into ``out`` when given (a contiguous tensor of y's
    shape, x's device and dtype, that does not overlap x), else into a new one.  Columns
    must lie in [0, m): the kernel reads x at them unchecked.

    Replaces the Pallas kernels ``_spmv_gather_jit`` and ``_spmv_affine_jit``
    (tpusparse/kernels/gather_ell.py): one CUDA kernel backs both."""
    if x.device.type == "cpu":
        return spmv_ell_plain(vals, cols, x, with_dot=with_dot, dot_offset=dot_offset,
                              out=out)
    m = check_field(x, x)
    n = _check_operand(vals, cols, x, m, dot_offset)
    y = row_out(out, x, x.shape if n == m else (n,))
    dot, part = dot_buffers(x, row_partials(n)) if with_dot else (None, None)
    fn = getattr(_build.lib(), f"tps_spmv_ell_{SUFFIX[x.dtype]}")
    _build.check(fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                    vals.shape[0], n, dot_offset, ptr(part), ptr(dot), stream(x)), "spmv_ell")
    LAUNCHES["spmv_ell"] += 1
    key = f"spmv_ell_w{vals.shape[0]}"
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return (y, dot) if with_dot else y


def _check_operand(vals, cols, x, m, dot_offset):
    """The operand's row count n, once it is checked against x of m elements."""
    if vals.device != x.device or vals.dtype != x.dtype:
        raise ValueError(f"ELL values on {vals.device}/{vals.dtype}, x on "
                         f"{x.device}/{x.dtype}")
    if cols.device != x.device or cols.dtype != torch.int32:
        raise ValueError(f"ELL columns must be int32 on {x.device}, got "
                         f"{cols.device}/{cols.dtype}")
    if vals.dim() != 2 or not 0 < vals.shape[1] <= m or cols.shape != vals.shape:
        raise ValueError(f"ELL operand must be (W, n) values and columns with n <= {m}, got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("the ELL operand must be contiguous")
    n = vals.shape[1]
    if not 0 <= dot_offset <= m - n:
        raise ValueError(f"dot_offset {dot_offset} outside [0, {m - n}]")
    return n

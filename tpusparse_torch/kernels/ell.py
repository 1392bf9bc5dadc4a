"""General-sparsity SpMV over a slot-major ELL operand: the CUDA kernel and its plain twin.

Counterpart of ``tpusparse/kernels/gather_ell.py``.  One wrapper backs both of its Pallas
kernels, which compute the same function:

  ``spmv_ell``  K12 ``_spmv_gather_jit`` (ladder pack) and K13 ``_spmv_affine_jit``
                (affine pack): y = A·x, optionally <x, A·x>

The operand is ``formats.csr_to_ell``'s, slot-major: ``vals`` (W, n) in the state's
dtype and ``cols`` (W, n) int32, column k of row i at [k, i] (``convert.ell_from_numpy``,
or ``generate.make_stencil5_ell_device``).  The matrix is square: x and y are fields of
the same n elements, of any shape.  y[i] = Σ_k vals[k, i]·x[cols[k, i]], summed from 0
over k = 0..W-1 in order.  None of the JAX package's packs is needed: not the column
windows, the select ladder, the affine and rot packs or the overflow scatter-add, which
answered Mosaic's lane-only gather, nor its fallback to the XLA gather for scattered
columns.  The kernel takes every sparsity.

``spmv_ell_plain`` is the twin, and the port of the XLA gather (``ops._init_ell_xla``,
modes ``csr-xla`` and ``ell``).  A wrapper given a CPU field runs the twin; given a CUDA
field it launches the kernel of ``tpusparse_torch/csrc/ell.cu`` or raises; there is no
fallback between the two.  Kernel and twin round every operation alike, so their y agree
bit for bit; the dots differ only in summation order.

``LAUNCHES["spmv_ell"]`` counts the kernel's launches (the twin does not count).
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import SUFFIX, check_field, dot_buffers, ptr, row_partials, stream

LAUNCHES = {"spmv_ell": 0}


def reset_launches() -> None:
    LAUNCHES["spmv_ell"] = 0


def spmv_ell_plain(vals, cols, x, *, with_dot=False):
    """Plain twin of ``spmv_ell``: one gather and one multiply-add per slot."""
    xf = x.reshape(-1)
    y = torch.zeros_like(xf)
    for k in range(vals.shape[0]):
        y.add_(vals[k] * xf.index_select(0, cols[k]))
    y = y.reshape(x.shape)
    return (y, torch.dot(xf, y.reshape(-1))) if with_dot else y


def spmv_ell(vals, cols, x, *, with_dot=False):
    """y = A·x for the slot-major ELL operand (vals, cols), or (y, <x, A·x>) when
    ``with_dot``.  Columns must lie in [0, n): the kernel reads x at them unchecked.

    Replaces the Pallas kernels ``_spmv_gather_jit`` and ``_spmv_affine_jit``
    (tpusparse/kernels/gather_ell.py): one CUDA kernel backs both."""
    if x.device.type == "cpu":
        return spmv_ell_plain(vals, cols, x, with_dot=with_dot)
    n = check_field(x, x)
    _check_operand(vals, cols, x, n)
    y = torch.empty_like(x)
    dot, part = dot_buffers(x, row_partials(n)) if with_dot else (None, None)
    fn = getattr(_build.lib(), f"tps_spmv_ell_{SUFFIX[x.dtype]}")
    _build.check(fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                    vals.shape[0], n, ptr(part), ptr(dot), stream(x)), "spmv_ell")
    LAUNCHES["spmv_ell"] += 1
    return (y, dot) if with_dot else y


def _check_operand(vals, cols, x, n):
    if vals.device != x.device or vals.dtype != x.dtype:
        raise ValueError(f"ELL values on {vals.device}/{vals.dtype}, x on "
                         f"{x.device}/{x.dtype}")
    if cols.device != x.device or cols.dtype != torch.int32:
        raise ValueError(f"ELL columns must be int32 on {x.device}, got "
                         f"{cols.device}/{cols.dtype}")
    if vals.dim() != 2 or vals.shape[1] != n or cols.shape != vals.shape:
        raise ValueError(f"ELL operand must be (W, {n}) values and columns, got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("the ELL operand must be contiguous")

"""Diagonal-offset (DIA) SpMV: the CUDA kernel and its plain twin.

Counterpart of ``tpusparse/kernels/dia.py``:

  ``spmv_dia``  K11 ``spmv_dia_pallas``: y = A·x, optionally <x, A·x>

The operand is ``formats.csr_to_dia``'s: ``data`` (ndiag, n) in the state's dtype and
``offsets`` (ndiag,) int64 on the same device (``convert.dia_from_numpy``, or
``generate.make_stencil5_dia_device``), with A[i, i + offsets[d]] = data[d, i].  The
matrix is square: x and y are fields of the same n elements, of any shape.
y[i] = Σ_d data[d, i]·x[i + offsets[d]], summed from 0 in the order of the diagonals (a
bf16 state rounds each product and each sum to bf16, as the JAX kernel's bf16 accumulator
does); a term whose x index leaves [0, n) is left out by select, never multiplied by a
padded zero, so whatever ``data`` holds there cannot reach y.  The JAX kernel's VMEM window, its
(q, s) lane split of each offset and its zero-padded x have no counterpart.

``spmv_dia_plain`` is the twin, and the port of the XLA operator (``ops._init_dia_xla``,
mode ``dia-xla``).  A wrapper given a CPU field runs the twin; given a CUDA field it
launches the kernel of ``tpusparse_torch/csrc/dia.cu`` or raises; there is no fallback
between the two.  Kernel and twin round every operation alike, so their y agree bit for
bit; the dots differ only in summation order.

``LAUNCHES["spmv_dia"]`` counts the kernel's launches (the twin does not count).
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import (SUFFIX, check_field, counter, dot_buffers, ptr, row_out, row_partials,
                      stream)
from .blas1 import dot_plain

LAUNCHES = counter(("spmv_dia",))


def reset_launches() -> None:
    LAUNCHES["spmv_dia"] = 0


def spmv_dia_plain(data, offsets, x, *, with_dot=False, out=None):
    """Plain twin of ``spmv_dia``: per diagonal, one multiply-add over the rows where it
    lies inside the matrix (``dia-xla``'s slices)."""
    xf = x.reshape(-1)
    n = xf.numel()
    y = torch.zeros_like(xf)
    for d, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            y[lo:hi] += data[d, lo:hi] * xf[lo + off:hi + off]
    y = y.reshape(x.shape) if out is None else out.copy_(y.reshape(x.shape))
    return (y, dot_plain(xf, y)) if with_dot else y


def spmv_dia(data, offsets, x, *, with_dot=False, out=None):
    """y = A·x for the DIA operand (data, offsets), or (y, <x, A·x>) when ``with_dot``; y
    goes into ``out`` when given (a field like x that does not overlap it).

    Replaces the Pallas kernel ``spmv_dia_pallas`` (tpusparse/kernels/dia.py)."""
    if x.device.type == "cpu":
        return spmv_dia_plain(data, offsets, x, with_dot=with_dot, out=out)
    n = check_field(x, x)
    _check_operand(data, offsets, x, n)
    y = row_out(out, x, x.shape)
    dot, part = dot_buffers(x, row_partials(n)) if with_dot else (None, None)
    fn = getattr(_build.lib(), f"tps_spmv_dia_{SUFFIX[x.dtype]}")
    _build.check(fn(data.data_ptr(), offsets.data_ptr(), x.data_ptr(), y.data_ptr(),
                    data.shape[0], n, ptr(part), ptr(dot), stream(x)), "spmv_dia")
    LAUNCHES["spmv_dia"] += 1
    return (y, dot) if with_dot else y


def _check_operand(data, offsets, x, n):
    if data.device != x.device or data.dtype != x.dtype:
        raise ValueError(f"DIA data on {data.device}/{data.dtype}, x on "
                         f"{x.device}/{x.dtype}")
    if offsets.device != x.device or offsets.dtype != torch.int64:
        raise ValueError(f"DIA offsets must be int64 on {x.device}, got "
                         f"{offsets.device}/{offsets.dtype}")
    if data.dim() != 2 or data.shape[1] != n or tuple(offsets.shape) != (data.shape[0],):
        raise ValueError(f"DIA operand must be (ndiag, {n}) data and (ndiag,) offsets, got "
                         f"{tuple(data.shape)} and {tuple(offsets.shape)}")
    if not (data.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("the DIA operand must be contiguous")

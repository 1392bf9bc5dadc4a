"""Carry matrices, operands and solver state into the port.

``stencil5_from_numpy`` and ``csr_from_numpy`` build the port's own ``formats.Stencil5`` and
``formats.CSRMatrix`` from numpy arrays: the way a matrix of another package (the JAX
package's, in the tests) comes in.  ``fields_from_numpy`` turns numpy arrays (x, r, p, halo
rows, scalars) into tensors, so a test can start two solvers from the same mid-solve state.
Of a ``Stencil5``, ``operand_from_stencil5`` reads the constant coefficients and
``planes_from_numpy`` carries the host coefficient planes to the device.  ``ell_from_numpy``
and ``dia_from_numpy`` carry the host packs (``formats.csr_to_ell``/``stencil5_to_ell``,
``formats.csr_to_dia``/``stencil5_to_dia``) to the device in the layouts the generic kernels
read.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .formats import C, N, CSRMatrix, Stencil5
from .generate import make_stencil5


def stencil5_from_numpy(grid_size, planes=None, constant=None) -> Stencil5:
    """A ``Stencil5`` of the port: coefficient planes (5, g, g) in the order N, W, C, E, S
    (copied, in their own dtype), or planes-free with ``constant`` = (diag, offdiag), or
    both."""
    g = int(grid_size)
    if planes is not None:
        planes = np.array(planes)
        if planes.shape != (5, g, g):
            raise ValueError(f"expected planes of shape (5, {g}, {g}), got {planes.shape}")
    elif constant is None:
        raise ValueError("a Stencil5 needs planes or constant coefficients")
    if constant is not None:
        constant = (float(constant[0]), float(constant[1]))
    return Stencil5(grid_size=g, planes=planes, constant=constant)


def csr_from_numpy(num_rows, num_cols, row_ptr, col_idx, values, grid_size=0) -> CSRMatrix:
    """A ``CSRMatrix`` of the port from its arrays (copied; int64 indices, float64 values),
    rows sorted by column as the stencil extraction needs."""
    row_ptr = np.array(row_ptr, dtype=np.int64)
    col_idx = np.array(col_idx, dtype=np.int64)
    values = np.array(values, dtype=np.float64)
    n, m = int(num_rows), int(num_cols)
    if row_ptr.shape != (n + 1,) or col_idx.shape != values.shape or row_ptr[-1] != col_idx.size:
        raise ValueError(f"inconsistent CSR: row_ptr {row_ptr.shape}, col_idx {col_idx.shape}, "
                         f"values {values.shape} for {n} rows")
    return CSRMatrix(num_rows=n, num_cols=m, row_ptr=row_ptr, col_idx=col_idx, val=values,
                     grid_size=int(grid_size))


def fields_from_numpy(arrays, device="cuda", dtype=None):
    """numpy array(s) -> tensor(s) on ``device``; a dict, list or tuple keeps its shape.
    ``dtype`` (a torch dtype) casts; None keeps each array's dtype.

    Always copies, also to the CPU: the solver updates x and r in place, and JAX on the
    CPU may still be reading the same numpy buffers (it can alias them and dispatches
    asynchronously)."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: fields_from_numpy(v, dev, dtype) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(fields_from_numpy(v, dev, dtype) for v in arrays)
    if arrays is None:
        return None
    return torch.tensor(np.asarray(arrays), dtype=dtype, device=dev)


def planes_from_numpy(planes, dtype=torch.float32, device="cuda"):
    """A Stencil5's host planes (5, g, g) (as ``generate.make_stencil5`` or, from a .mtx,
    ``formats.csr_to_stencil5`` gives them) as a contiguous tensor in ``dtype`` on
    ``device``; bfloat16 rounds each coefficient once, from the host's precision.  Always
    copies."""
    planes = np.asarray(planes)
    if planes.ndim != 3 or planes.shape[0] != 5:
        raise ValueError(f"expected planes of shape (5, rows, g), got {planes.shape}")
    return torch.tensor(planes, dtype=dtype, device=resolve_device(device))


def operand_from_stencil5(st: Stencil5):
    """(diag, offdiag) of a constant-coefficient Stencil5.

    Uses ``st.constant`` when set; otherwise ``st.planes`` must be exactly the Dirichlet
    stencil that ``make_stencil5`` builds for some (diag, offdiag).  General coefficient
    planes need the values-carrying operator, mode ``stencil5``."""
    if st.constant is not None:
        diag, offdiag = st.constant
        return float(diag), float(offdiag)
    planes = st.planes
    if planes is None:
        raise ValueError("Stencil5 has neither constant coefficients nor planes")
    g = st.grid_size
    diag = float(planes[C].flat[0])
    offdiag = float(planes[N, 1, 0]) if g > 1 else 0.0
    if not np.array_equal(planes, make_stencil5(g, diag, offdiag, dtype=planes.dtype).planes):
        raise ValueError(
            "the stencil5-const operator needs uniform coefficients; for general coefficient "
            "planes use mode 'stencil5' (the values-carrying operator)")
    return diag, offdiag


def ell_from_numpy(col, val, dtype=torch.float32, device="cuda"):
    """An ELL pack (``ELLMatrix.col``/``.val``, (n, W) each) as the slot-major operand of
    ``kernels.ell``: values (W, n) in ``dtype`` and columns (W, n) int32, so that the
    threads of a warp, on neighbouring rows, read neighbouring addresses.  Always
    copies."""
    col, val = np.asarray(col), np.asarray(val)
    if col.ndim != 2 or col.shape != val.shape:
        raise ValueError(f"expected (n, W) columns and values, got {col.shape} and {val.shape}")
    if col.size and (col.min() < 0 or col.max() >= 2 ** 31):
        raise ValueError("ELL columns must lie in [0, 2**31) for the int32 operand")
    dev = resolve_device(device)
    return (torch.tensor(np.ascontiguousarray(val.T), dtype=dtype, device=dev),
            torch.tensor(np.ascontiguousarray(col.T, dtype=np.int32), device=dev))


def dia_from_numpy(data, offsets, dtype=torch.float32, device="cuda"):
    """A DIA pack (``DIAMatrix.data`` (ndiag, n), ``.offsets`` (ndiag,)) as the operand of
    ``kernels.dia``: data in ``dtype`` and offsets int64, both on ``device``.  Always
    copies."""
    data, offsets = np.asarray(data), np.asarray(offsets)
    if data.ndim != 2 or offsets.shape != (data.shape[0],):
        raise ValueError(f"expected (ndiag, n) data and (ndiag,) offsets, got {data.shape} "
                         f"and {offsets.shape}")
    dev = resolve_device(device)
    return (torch.tensor(data, dtype=dtype, device=dev),
            torch.tensor(offsets, dtype=torch.int64, device=dev))

"""Carry operands and solver state across from the JAX package.

``fields_from_numpy`` turns numpy arrays (as ``np.asarray`` gives them from JAX arrays:
x, r, p, halo rows, scalars) into tensors, so a test can start both packages from the
same mid-solve state.  Of the shared ``tpusparse.formats.Stencil5``,
``operand_from_stencil5`` reads the constant coefficients and ``planes_from_numpy`` carries
the host coefficient planes to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse.formats import C, N, Stencil5
from tpusparse.generate import make_stencil5

from ._device import resolve_device


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
    """A Stencil5's host planes (5, g, g) (as ``make_stencil5`` or, from a .mtx,
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

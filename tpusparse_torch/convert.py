"""Carry operands and solver state across from the JAX package.

``fields_from_numpy`` turns numpy arrays (as ``np.asarray`` gives them from JAX arrays:
x, r, p, halo rows, scalars) into tensors, so a test can start both packages from the
same mid-solve state.  ``operand_from_stencil5`` reads the constant coefficients of the
shared ``tpusparse.formats.Stencil5``.
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


def operand_from_stencil5(st: Stencil5):
    """(diag, offdiag) of a constant-coefficient Stencil5.

    Uses ``st.constant`` when set; otherwise ``st.planes`` must be exactly the Dirichlet
    stencil that ``make_stencil5`` builds for some (diag, offdiag).  A values-carrying
    operand with general coefficients needs the planes kernel (ROADMAP Queue 1 item 8)."""
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
        raise NotImplementedError(
            "the stencil5-const operator needs uniform coefficients; general coefficient "
            "planes need the values-carrying kernel (ROADMAP Queue 1 item 8, not ported)")
    return diag, offdiag

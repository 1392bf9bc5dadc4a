"""Operand and vector synthesis for the port.

The host generators and the analytic checksums are shared with ``tpusparse.generate``
(plain numpy) and re-exported here.  ``make_stencil5_planes_device`` builds the stencil's
coefficient planes, and ``ones_field`` the canonical x = ones / b = ones field, directly
on the target device in the target dtype.
"""

from __future__ import annotations

import torch

from tpusparse.formats import C, E, N, S, W
from tpusparse.generate import (  # noqa: F401  (re-exported)
    DEFAULT_DIAG,
    DEFAULT_OFFDIAG,
    make_stencil5,
    stencil5_nnz,
    stencil5_spmv_checksums,
)

from ._device import resolve_device


def ones_field(grid_size: int, dtype=torch.float32, device="cuda"):
    """The reference's canonical input vector x = ones as a (g, g) field, made on the
    device in the target dtype (no host staging copy)."""
    return torch.ones((grid_size, grid_size), dtype=dtype, device=resolve_device(device))


def make_stencil5_planes_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                                dtype=torch.float32, device="cuda"):
    """The (5, g, g) coefficient planes of the g×g stencil, in the order N, W, C, E, S,
    made on the device in ``dtype``: the port of ``tpusparse.generate.
    make_stencil5_planes_device``, with the masks of ``make_stencil5`` (row 0 has no N, the
    last row no S, column 0 no W, the last column no E).

    One (5, g, g) tensor is allocated and each plane filled in place, so the peak footprint
    is the output alone: five (g, g) planes and a ``torch.stack`` would double it (16.8 GB
    for f32 at 20480²).  bfloat16 is filled directly, never through an f32 copy; 5, -1 and 0
    are exact in it."""
    g = int(grid_size)
    if g < 1:
        raise ValueError("grid_size must be >= 1")
    planes = torch.empty((5, g, g), dtype=dtype, device=resolve_device(device))
    planes[C].fill_(diag)
    for d in (N, S, W, E):
        planes[d].fill_(offdiag)
    planes[N, 0].zero_()
    planes[S, -1].zero_()
    planes[W, :, 0].zero_()
    planes[E, :, -1].zero_()
    return planes

"""Operand and vector synthesis for the port.

The host generators and the analytic checksums are shared with ``tpusparse.generate``
(plain numpy) and re-exported here; ``ones_field`` builds the canonical x = ones / b = ones
field directly on the target device.
"""

from __future__ import annotations

import torch

from tpusparse.generate import (  # noqa: F401  (re-exported)
    make_stencil5,
    stencil5_nnz,
    stencil5_spmv_checksums,
)

from ._device import resolve_device


def ones_field(grid_size: int, dtype=torch.float32, device="cuda"):
    """The reference's canonical input vector x = ones as a (g, g) field, made on the
    device in the target dtype (no host staging copy)."""
    return torch.ones((grid_size, grid_size), dtype=dtype, device=resolve_device(device))

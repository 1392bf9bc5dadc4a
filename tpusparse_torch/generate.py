"""Operand and vector synthesis for the port.

The host generators and the analytic checksums are shared with ``tpusparse.generate``
(plain numpy) and re-exported here.  ``make_stencil5_planes_device`` builds the stencil's
coefficient planes, ``make_stencil5_ell_device`` and ``make_stencil5_dia_device`` its ELL
and DIA operands, and ``ones_field`` the canonical x = ones / b = ones field, directly on
the target device in the target dtype.
"""

from __future__ import annotations

import numpy as np
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


def stencil5_ell_device_ok(grid_size: int, diag, offdiag) -> bool:
    """Whether ``make_stencil5_ell_device`` takes this stencil: the contract of the analytic
    pack it ports (g ≥ 3, both coefficients nonzero)."""
    return int(grid_size) >= 3 and diag != 0.0 and offdiag != 0.0


def stencil5_dia_device_ok(grid_size: int) -> bool:
    """Whether ``make_stencil5_dia_device`` takes this grid: g ≥ 2 (at g = 1 the offsets
    ±1 and ±g collide)."""
    return int(grid_size) >= 2


def make_stencil5_ell_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                             dtype=torch.float32, device="cuda"):
    """The slot-major ELL operand of the constant g×g stencil, made on the device: values
    (5, g²) in ``dtype`` and columns (5, g²) int32, the operand ``convert.ell_from_numpy``
    makes of ``formats.stencil5_to_ell`` — the port of its analytic path,
    ``formats._stencil5_const_to_ell``, and bit-equal to it, with its contract: g ≥ 3 and
    both coefficients nonzero (ValueError otherwise).

    Every row is first written as an interior row, columns r + (−g, −1, 0, +1, +g) with
    values (o, o, d, o, o); then the 4g − 4 boundary rows are rewritten: their real
    columns packed to the left in N, W, C, E, S order, the pad slots holding the last real
    column with value 0.  Values round through float32, as the host pack stores them.  At
    20480² the host pack would be 16.8 GB of int64 columns and 8.4 GB of values."""
    g = int(grid_size)
    if not stencil5_ell_device_ok(g, diag, offdiag):
        raise ValueError("the analytic stencil ELL needs g >= 3 and nonzero coefficients "
                         "(formats.stencil5_to_ell packs the others on the host)")
    n = g * g
    if n >= 2 ** 31 - g:
        raise ValueError(f"grid {g} too large for int32 columns")
    dev = resolve_device(device)
    d32, o32 = float(np.float32(diag)), float(np.float32(offdiag))
    cols = torch.empty((5, n), dtype=torch.int32, device=dev)
    torch.arange(n, dtype=torch.int32, device=dev, out=cols[2])
    for slot, shift in ((0, -g), (1, -1), (3, 1), (4, g)):
        torch.add(cols[2], shift, out=cols[slot])
    vals = torch.full((5, n), o32, dtype=dtype, device=dev)
    vals[2].fill_(d32)

    # the boundary rows: i = 0, i = g-1 (both with their corners), then j = 0 and
    # j = g-1 between them, as the host pack orders them
    edge = torch.cat([torch.arange(g, device=dev), torch.arange(n - g, n, device=dev),
                      torch.arange(g, n - g, g, device=dev),
                      torch.arange(2 * g - 1, n - g, g, device=dev)])
    ei, ej = edge // g, edge % g
    cand = torch.stack([edge - g, edge - 1, edge, edge + 1, edge + g], dim=1)
    ok = torch.stack([ei > 0, ej > 0, torch.ones_like(ei, dtype=torch.bool), ej < g - 1,
                      ei < g - 1], dim=1)
    m = edge.numel()
    lens = ok.sum(dim=1)
    pos = ok.cumsum(dim=1) - 1
    rr = torch.arange(m, device=dev)[:, None].expand(m, 5)[ok]
    ecol = torch.zeros((m, 5), dtype=torch.int64, device=dev)
    ecol[rr, pos[ok]] = cand[ok]
    evals = torch.zeros((m, 5), dtype=dtype, device=dev)
    vals5 = torch.tensor([o32, o32, d32, o32, o32], dtype=dtype, device=dev)
    evals[rr, pos[ok]] = vals5.expand(m, 5)[ok]
    last = ecol[torch.arange(m, device=dev), lens - 1]  # lens >= 3: always a real column
    pad = torch.arange(5, device=dev)[None, :] >= lens[:, None]
    ecol = torch.where(pad, last[:, None], ecol)
    cols[:, edge] = ecol.T.to(torch.int32)
    vals[:, edge] = evals.T
    return vals, cols


def make_stencil5_dia_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                             dtype=torch.float32, device="cuda"):
    """The DIA operand of the g×g stencil, made on the device: data (5, g²) in ``dtype``
    and offsets (−g, −1, 0, +1, +g) int64.  By ``formats.stencil5_to_dia``'s own account
    the DIA data of the stencil is exactly its coefficient planes N, W, C, E, S, with the
    planes' edge masks as the zeros where a diagonal leaves the matrix, so this is
    ``make_stencil5_planes_device`` seen as (5, g²).  Values round through float32, as the
    host pack stores them, so this equals ``convert.dia_from_numpy`` of
    ``formats.stencil5_to_dia``.  g ≥ 2 (at g = 1 the offsets collide; ValueError)."""
    g = int(grid_size)
    if not stencil5_dia_device_ok(g):
        raise ValueError("the stencil's DIA needs g >= 2: at g = 1 the offsets ±1 and ±g "
                         "collide")
    data = make_stencil5_planes_device(g, float(np.float32(diag)), float(np.float32(offdiag)),
                                       dtype=dtype, device=device)
    offsets = torch.tensor([-g, -1, 0, 1, g], dtype=torch.int64, device=data.device)
    return data.reshape(5, g * g), offsets

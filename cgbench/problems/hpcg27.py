"""hpcg27: HPCG's problem (https://github.com/hpcg-benchmark/hpcg, src/GenerateProblem_ref.cpp),
the 27-point stencil on an nx × ny × nz grid with Dirichlet edges: each point coupled to
itself with ``diag`` and to each of its up to 26 neighbours on the grid with ``offdiag``
(HPCG's 26 and −1).  The field is (nz, ny, nx), so that its flat index is HPCG's row,
iz·nx·ny + iy·nx + ix.  One card only: no ``sharded_operator``."""

from __future__ import annotations

import torch

# the 26 neighbour offsets (sz, sy, sx), the point itself left out
NEIGHBOURS = tuple((sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)
                   if (sz, sy, sx) != (0, 0, 0))


def shape(config: dict, grid: int | None = None) -> tuple:
    if grid:
        return (grid, grid, grid)
    return (config["nz"], config["ny"], config["nx"])


def operand(config: dict, grid: int | None = None):
    """The constant 27-point stencil, whose ELL operand the program makes on the
    device."""
    from tpusparse_torch.formats import Stencil27

    nz, ny, nx = shape(config, grid)
    return Stencil27(nx, ny, nz, (config["diag"], config["offdiag"]))


def _part(n: int, s: int, shifted: bool) -> slice:
    """Along one axis of n points: the points whose neighbour at offset s lies on the grid
    (``shifted`` False), or those neighbours (True)."""
    if shifted:
        return slice(max(0, s), n - max(0, -s))
    return slice(max(0, -s), n - max(0, s))


def apply(x, config: dict, out=None):
    """A·x for a (nz, ny, nx) field x, into ``out`` when given (it must not overlap x):
    diag·x, then offdiag times each neighbour's value added where the neighbour lies on
    the grid, one offset at a time, in place, with no temporary field."""
    y = torch.mul(x, config["diag"], out=out) if out is not None else x * config["diag"]
    for s in NEIGHBOURS:
        dst = tuple(_part(n, si, False) for n, si in zip(x.shape, s))
        src = tuple(_part(n, si, True) for n, si in zip(x.shape, s))
        y[dst].add_(x[src], alpha=config["offdiag"])
    return y

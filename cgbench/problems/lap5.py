"""lap5: the 2-D 5-point stencil on a g×g grid with Dirichlet edges, diag and offdiag the
configuration's (``grid_size``, ``diag``, ``offdiag``): the reference's STENCIL5 problem.
The problem of every configuration that names none."""

from __future__ import annotations

from cgbench.reference import cg as reference


def shape(config: dict, grid: int | None = None) -> tuple:
    g = grid or config["grid_size"]
    return (g, g)


def operand(config: dict, grid: int | None = None):
    """The planes-free constant stencil, whose operands the program makes on the
    device."""
    from tpusparse_torch.formats import Stencil5

    return Stencil5(shape(config, grid)[0], None, (config["diag"], config["offdiag"]))


def apply(x, config: dict, out=None):
    return reference.stencil_apply(x, config["diag"], config["offdiag"], out=out)


def sharded_operator(config: dict, grid: int | None, mode: str, dtype, device):
    """A rank's row band of the stencil (``cg_sharded.make_sharded_operator``)."""
    from tpusparse_torch.solvers import cg_sharded

    return cg_sharded.make_sharded_operator(
        shape(config, grid)[0], mode=mode, diag=config["diag"], offdiag=config["offdiag"],
        dtype=dtype, device=device)

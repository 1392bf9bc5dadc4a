"""Conjugate Gradient, written out from its definition, and the 5-point stencil it runs on
by default.

``solve`` takes A as a function; ``cg`` is ``solve`` on the 5-point stencil.  That A is the
g×g grid's 5-point stencil with Dirichlet edges: (A·x)[i, j] = diag·x[i, j] +
offdiag·(x[i−1, j] + x[i+1, j] + x[i, j−1] + x[i, j+1]), a neighbour off the grid
counting 0.  The solve is the textbook CG from x0 = 0 that the program states:

    r = b ; p = r ; rr = <r, r> ; stop once rr <= tol²·<b, b> or after max_iters
    loop:  Ap = A·p ; α = rr / <p, Ap> ; x += α·p ; r −= α·Ap
           rr' = <r, r> ; β = rr' / rr ; p = r + β·p

Everything is float64 on b's device, whatever b's dtype, one whole-field operation at a
time with no temporary field: x, r, p, Ap and b's f64 copy are the memory it takes.
"""

from __future__ import annotations

import torch


def stencil_apply(x: torch.Tensor, diag: float, offdiag: float,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """A·x for a (g, g) field x, into ``out`` when given (it must not overlap x)."""
    y = torch.mul(x, diag, out=out) if out is not None else x * diag
    y[1:].add_(x[:-1], alpha=offdiag)
    y[:-1].add_(x[1:], alpha=offdiag)
    y[:, 1:].add_(x[:, :-1], alpha=offdiag)
    y[:, :-1].add_(x[:, 1:], alpha=offdiag)
    return y


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a.reshape(-1), b.reshape(-1)))


def cg(b: torch.Tensor, diag: float, offdiag: float, tol: float,
       max_iters: int) -> tuple[torch.Tensor, int]:
    """(x, iterations) of the stencil's CG on the (g, g) right-hand side b, in float64."""
    def apply(x, out=None):
        return stencil_apply(x, diag, offdiag, out=out)

    return solve(b, apply, tol, max_iters)


def solve(b: torch.Tensor, apply, tol: float, max_iters: int) -> tuple[torch.Tensor, int]:
    """(x, iterations) of CG on the right-hand side b, a field of any shape, in float64:
    ``apply(x, out=y)`` writes A·x for a float64 field x of b's shape into y."""
    r = b.to(torch.float64, copy=True)
    x = torch.zeros_like(r)
    p = r.clone()
    ap = torch.empty_like(r)
    rr = _dot(r, r)
    tol2 = tol * tol * rr
    k = 0
    while k < max_iters and rr > tol2:
        apply(p, out=ap)
        alpha = rr / _dot(p, ap)
        x.add_(p, alpha=alpha)
        r.add_(ap, alpha=-alpha)
        rr_new = _dot(r, r)
        p.mul_(rr_new / rr).add_(r)
        rr = rr_new
        k += 1
    return x, k


def dense_matrix(g: int, diag: float, offdiag: float) -> torch.Tensor:
    """The stencil as a dense (g², g²) float64 matrix, row i·g + j for point (i, j): for
    checking ``stencil_apply`` at small g."""
    n = g * g
    a = torch.zeros((n, n), dtype=torch.float64)
    for i in range(g):
        for j in range(g):
            row = i * g + j
            a[row, row] = diag
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                if 0 <= i + di < g and 0 <= j + dj < g:
                    a[row, (i + di) * g + j + dj] = offdiag
    return a

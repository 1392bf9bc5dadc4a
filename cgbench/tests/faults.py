"""Faults planted under the timed path, for the tests that see ``correct`` come out false.
Each takes a run's timed solve and returns the broken one; they are importable by name, so
that a rank of a run spawned in its own process can apply them too.  A fault planted in
the program holds only while the broken solve runs."""

from __future__ import annotations

import contextlib

# how much looser the early stop's test of convergence is: rr ≤ (8·tol)²·<b, b> stops
# three iterations early on these grids (rr falls about 4× an iteration)
LOOSER = 8.0


@contextlib.contextmanager
def _patched(*patches):
    """Set each (object, attribute, value) while the block runs, then put the old ones
    back."""
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def unchanged(solve):
    """A solve that returns its state unchanged: x as it started, x0 = 0."""
    def broken():
        x, stats = solve()
        x.zero_()
        return x, stats
    return broken


def half_left_out(solve):
    """A solve whose second half of the rows is left out: their x stays at x0 = 0."""
    def broken():
        x, stats = solve()
        rows = x.reshape(x.shape[0], -1)
        rows[rows.shape[0] // 2:] = 0
        return x, stats
    return broken


def altered(solve):
    """A solve with one answer altered where it is produced: one point of x off by 1."""
    def broken():
        x, stats = solve()
        x.reshape(-1)[x.numel() // 3] += 1
        return x, stats
    return broken


def early_stop(solve):
    """A solve that stops early: the program's test of convergence ``LOOSER`` times
    looser, on one card (``cg.cg_solve``) and on ranks (``cg_sharded.cg_solve_sharded``)."""
    import dataclasses

    from tpusparse_torch.solvers import cg, cg_sharded

    one, sharded = cg.cg_solve, cg_sharded.cg_solve_sharded

    def one_loose(op, b, config, **kw):
        return one(op, b, config=dataclasses.replace(
            config, tolerance=config.tolerance * LOOSER), **kw)

    def sharded_loose(*args, tolerance, **kw):
        return sharded(*args, tolerance=tolerance * LOOSER, **kw)

    def broken():
        with _patched((cg, "cg_solve", one_loose),
                      (cg_sharded, "cg_solve_sharded", sharded_loose)):
            return solve()
    return broken


def no_exchange(solve):
    """Ranks that leave out the exchange between them: no halo row is sent or received,
    so each band is solved with what its halo buffers held.  Planted both in the eager
    exchange (``_HaloExchange``, gloo ranks) and in the rank link that a graph a rank
    captures (``_RankLink``, NCCL ranks: the timed path on cards)."""
    from tpusparse_torch.solvers import cg_sharded

    halo, link = cg_sharded._HaloExchange, cg_sharded._RankLink

    def broken():
        with _patched((halo, "start", lambda self, *args, **kwargs: None),
                      (halo, "finish", lambda self: self.halos()),
                      (link, "start", lambda self, *args, **kwargs: None),
                      (link, "finish", lambda self: None)):
            return solve()
    return broken

"""solve_ms: the window's wall time over the solves it completed.  On several ranks
(solve_ms.ranks) rank 0's wall time between the barriers that open and close the window,
over the solves every rank completed in it."""

from cgbench import window


def read(run):
    return window.rate_ms(run.total_s, len(run.times_ms))

"""solve_ms_p90: the nearest-rank 90th percentile of the window's per-solve times.  On
several ranks (solve_ms_p90.ranks) rank 0's, from one solve's end to the next's (the ranks
meet inside every solve)."""

from cgbench import window


def read(run):
    return window.percentile(run.times_ms, 90)

"""first_solve_s: the benchmark's host timer around the first solve, which loads the
kernels and captures and replays the graph loop (on several ranks the slowest rank's)."""


def read(run):
    return run.first_solve_s

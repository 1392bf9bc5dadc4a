"""setup_s: from the process's start to the opening of the window: imports, the
kernels' load (their build on a checkout's first run), b and the operator made on the
card, the graph loop's captures and the warm-up."""


def read(run):
    return run.setup_s

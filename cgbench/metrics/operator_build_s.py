"""operator_build_s: the benchmark's host timer around the program's operator
construction, ending in a synchronise (on several ranks the slowest rank's, NCCL's
group made with it)."""


def read(run):
    return run.operator_build_s

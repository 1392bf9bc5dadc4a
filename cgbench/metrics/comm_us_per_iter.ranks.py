"""comm_us_per_iter.ranks: the device time of NCCL's kernels a CG iteration in the traced
segment, the largest over the ranks."""


def read(run):
    if not run.traces or not any(tr["comm_s"] > 0 for tr in run.traces):
        return None
    return max(tr["comm_s"] / tr["iterations"] * 1e6 for tr in run.traces)

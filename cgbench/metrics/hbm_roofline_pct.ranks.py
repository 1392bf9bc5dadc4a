"""hbm_roofline_pct.ranks: hbm_roofline_pct on each rank's band, read on the rank whose
device time is the longest; NCCL's kernels are left out of the device time, which
comm_us_per_iter.ranks reads."""

from cgbench import roofline


def read(run):
    if not run.traces or any(tr["compute_s"] <= 0 for tr in run.traces):
        return None
    r = max(range(len(run.traces)), key=lambda i: run.traces[i]["compute_s"])
    tr = run.traces[r]
    least = roofline.least_s(run.cell.traffic, run.itemsize, run.points[r],
                             tr["iterations"], run.kind)
    return None if least is None else 100.0 * least / tr["compute_s"]

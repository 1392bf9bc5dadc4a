"""hbm_roofline_pct: the least time of a traced solve's iterations (the traffic's fewest
bytes a point an iteration, over the card's published HBM rate) over the device time of
a traced solve's operations."""

from cgbench import roofline


def read(run):
    if not run.traces or run.traces[0]["compute_s"] <= 0:
        return None
    tr = run.traces[0]
    least = roofline.least_s(run.cell.traffic, run.itemsize, run.points[0],
                             tr["iterations"], run.kind)
    return None if least is None else 100.0 * least / tr["compute_s"]

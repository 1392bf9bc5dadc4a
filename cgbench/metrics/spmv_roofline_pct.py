"""spmv_roofline_pct: the SpMV kernel's least time in the traced segment (the traffic's
``spmv`` bytes a point, over the card's published HBM rate, times the points and the
traced iterations, one SpMV an iteration) over its device time there, the sum of the
traced operations whose name holds the traffic's ``spmv`` kernel name.  None where the
traffic has no ``spmv`` entry or the trace no such operation."""

from cgbench import roofline


def read(run):
    spmv = run.cell.traffic.get("spmv")
    if spmv is None or not run.traces:
        return None
    tr = run.traces[0]
    device_s = sum(s for name, s in tr["ops"].items() if spmv["kernel"] in name)
    if device_s <= 0:
        return None
    least = roofline.least_s({"roofline": spmv}, run.itemsize, run.points[0],
                             tr["iterations"], run.kind)
    return None if least is None else 100.0 * least / device_s

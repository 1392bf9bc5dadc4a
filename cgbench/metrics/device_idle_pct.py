"""device_idle_pct: the traced segment's length less the union of the device's
operations in it, as a share of its length."""

from cgbench import trace


def read(run):
    if not run.traces or run.traces[0]["busy_s"] <= 0:
        return None
    tr = run.traces[0]
    return trace.idle_pct(tr["window_s"], tr["busy_s"])

"""device_idle_pct.ranks: device_idle_pct on each rank's card, the largest over the
ranks."""

from cgbench import trace


def read(run):
    if not run.traces or any(tr["busy_s"] <= 0 for tr in run.traces):
        return None
    return max(trace.idle_pct(tr["window_s"], tr["busy_s"]) for tr in run.traces)

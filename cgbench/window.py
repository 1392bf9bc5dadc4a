"""The closed loop of one client and the statistics taken over its window.

A solve runs from x0 = 0 to convergence and returns only once its result is on the
host's side of a synchronise (the program reads (rr, <b, b>, k) at its end), so the host
clock between two solve ends is a solve's time.  Solves run back to back: the next starts
when the last returned.

The window's rate is its whole wall time over the solves it completed, so a stall inside
it shows in full; its tail is the nearest-rank percentile of every solve's time.  The
answer kept for the check is one solve drawn from the seed over the whole window
(reservoir sampling: solve i replaces the kept one with probability 1/(i + 1)), so the
program keeps at most two solutions alive: the kept one and the current one.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
import time


@dataclasses.dataclass
class Window:
    times_ms: list  # every solve's time, in order
    total_s: float  # from the window's opening to the last solve's end
    iterations: list  # every solve's iteration count
    failed: int  # solves that did not converge
    kept: object  # the sampled solve's x
    kept_index: int
    kept_iterations: int


def rate_ms(total_s: float, solves: int) -> float:
    """The window's milliseconds a solve: its whole time over the solves completed."""
    return total_s * 1e3 / solves


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least q% of the values
    at or below it (of 100 values the 90th leaves 10 above it)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartiles (``statistics.quantiles``) as a
    share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def settled(times_ms, rule: dict) -> bool:
    """Whether warm-up may end: at least ``min_solves`` solves, and the last ``last`` of
    them within ``settle`` of their median, or ``max_s`` seconds of warm-up spent."""
    if len(times_ms) < rule["min_solves"]:
        return False
    if sum(times_ms) / 1e3 >= rule["max_s"]:
        return True
    tail = times_ms[-rule["last"]:]
    return (max(tail) - min(tail)) / statistics.median(tail) <= rule["settle"]


def run(solve, seed: int, *, seconds: float | None = None, count: int | None = None,
        clock=time.perf_counter) -> Window:
    """Solve back to back until ``seconds`` have passed since the opening (the last solve
    finishing past it) or ``count`` solves are done.  ``solve()`` returns (x, CGStats)."""
    if (seconds is None) == (count is None):
        raise ValueError("give the window seconds or a count of solves")
    rng = random.Random(seed)
    times, iters, failed = [], [], 0
    kept = kept_index = kept_iterations = None
    opened = last = clock()
    i = 0
    while True:
        x, stats = solve()
        now = clock()
        times.append((now - last) * 1e3)
        last = now
        iters.append(stats.iterations)
        failed += not stats.converged
        if rng.randrange(i + 1) == 0:
            kept, kept_index, kept_iterations = x, i, stats.iterations
        del x
        i += 1
        if (count is not None and i >= count) or (seconds is not None
                                                  and now - opened >= seconds):
            break
    return Window(times, last - opened, iters, failed, kept, kept_index, kept_iterations)


def first_solves(solve) -> float:
    """The first solve, which builds and captures what the program's loop needs, then a
    second one while the first one's x is held, so that both solution slots the window
    uses are captured before it opens.  Returns the first solve's seconds."""
    t0 = time.perf_counter()
    held, _ = solve()
    first_s = time.perf_counter() - t0
    x, _ = solve()
    del held, x
    return first_s


def warm_up(solve, rule: dict, decide=lambda done: done) -> list:
    """Solve until ``settled``; returns the warm-up solves' times in ms.  ``decide`` turns
    this process's verdict into the group's (ranks agree on rank 0's)."""
    times = []
    while True:
        t0 = time.perf_counter()
        x, _ = solve()
        del x
        times.append((time.perf_counter() - t0) * 1e3)
        if decide(settled(times, rule)):
            return times

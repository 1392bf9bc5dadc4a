"""The window's statistics and its closed loop, on synthetic timings."""

from __future__ import annotations

import dataclasses

import pytest

from cgbench import window


@dataclasses.dataclass
class Stats:
    iterations: int = 20
    converged: bool = True


class FakeSolves:
    """Solves whose durations come from a list, on a clock that they advance."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.now = 0.0
        self.done = 0

    def clock(self):
        return self.now

    def __call__(self):
        self.now += self.durations[self.done % len(self.durations)]
        self.done += 1
        return object(), Stats()


def test_rate_and_p90_over_the_whole_window():
    steady = [0.1] * 100
    stalled = [0.1] * 99 + [2.0]  # one solve stalls for 1.9 s more
    for times in (steady, stalled):
        solves = FakeSolves(times)
        w = window.run(solves, seed=7, count=100, clock=solves.clock)
        assert len(w.times_ms) == 100
        assert window.rate_ms(w.total_s, 100) == pytest.approx(sum(times) * 10)
    # the stall moves the rate by its whole length over the solves
    assert window.rate_ms(sum(stalled), 100) - window.rate_ms(sum(steady), 100) == \
        pytest.approx(19.0)
    # and a tail of ten slow solves moves the 90th percentile, which leaves ten above it
    tail = [0.1] * 89 + [0.5] * 11
    assert window.percentile([t * 1e3 for t in steady], 90) == pytest.approx(100.0)
    assert window.percentile([t * 1e3 for t in tail], 90) == pytest.approx(500.0)
    assert window.percentile(list(range(1, 101)), 90) == 90


def test_window_by_seconds_ends_after_the_solve_that_crosses_them():
    solves = FakeSolves([0.3])
    w = window.run(solves, seed=1, seconds=1.0, clock=solves.clock)
    assert len(w.times_ms) == 4  # 0.3, 0.6, 0.9, 1.2
    assert w.total_s == pytest.approx(1.2)
    assert w.times_ms == pytest.approx([300.0] * 4)


def test_the_kept_solve_is_drawn_from_the_seed_over_the_whole_window():
    def kept(seed):
        solves = FakeSolves([0.1])
        return window.run(solves, seed=seed, count=50, clock=solves.clock).kept_index

    assert kept(3) == kept(3)
    picks = [kept(s) for s in range(400)]
    assert min(picks) < 10 and max(picks) > 40  # not always the first or the last
    assert sum(p < 25 for p in picks) == pytest.approx(200, abs=45)


def test_window_needs_one_limit():
    with pytest.raises(ValueError):
        window.run(FakeSolves([0.1]), seed=1)
    with pytest.raises(ValueError):
        window.run(FakeSolves([0.1]), seed=1, seconds=1.0, count=3)


def test_settled_and_spread():
    rule = {"min_solves": 3, "last": 3, "settle": 0.005, "max_s": 5.0}
    assert not window.settled([100.0, 100.0], rule)
    assert window.settled([300.0, 100.0, 100.2, 100.1], rule)
    assert not window.settled([100.0, 110.0, 100.0], rule)
    assert window.settled([3000.0, 2500.0, 1000.0], rule)  # five seconds spent
    assert window.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)

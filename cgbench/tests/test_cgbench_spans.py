"""The readings of the program's spans (``cgbench.spans``) on synthetic summaries: a
start span with two launches, ranks whose solves begin 40 µs apart, set-up's spans, the
idle split by span, and a run with no program spans, where each reading is None; then
the tool's runs of every cell on the CPU at g = 24 (no device time there)."""

from __future__ import annotations

import time

import pytest

from cgbench import spec, spans, trace

US, MS = 1_000, 1_000_000


def _span(name, start, end, parent=None, solve=None, **attrs):
    return [name, start, end, parent, solve, attrs]


def _rank(offset=0, start_ops=((1 * MS, 2 * MS), (1500 * US, 3 * MS))):
    """A rank's summary: set-up (a kernel load, an operator with an NCCL group in it, a
    capture) before the traced range [100, 200] ms, then two traced solves (ids 7, 8) of
    40 ms each, ``offset`` ns later than rank 0's; the first solve's start launches
    ``start_ops`` (device intervals relative to its start), the second's one 1 ms op."""
    t = offset
    out = [_span("Kernel_Load", 0, 2 * MS, built=False),
           _span("Operator_Build", 3 * MS, 9 * MS),
           _span("NCCL_Group", 4 * MS, 8 * MS, parent=1),
           _span("CG_Solver", 10 * MS, 60 * MS, solve=1),
           _span("CG_Slot", 10 * MS, 50 * MS, parent=3, solve=1),
           _span("CG_Capture", 11 * MS, 49 * MS, parent=4, solve=1)]
    launched = []
    for solve, s0 in ((7, 110 * MS + t), (8, 150 * MS + t)):
        i = len(out)
        out += [_span("CG_Solver", s0, s0 + 40 * MS, solve=solve),
                _span("CG_Slot", s0, s0 + 1 * MS, parent=i, solve=solve),
                _span("CG_Start", s0 + 1 * MS, s0 + 5 * MS, parent=i, solve=solve),
                _span("CG_Replay", s0 + 5 * MS, s0 + 6 * MS, parent=i, solve=solve),
                _span("CG_Read", s0 + 6 * MS, s0 + 40 * MS, parent=i, solve=solve)]
        ops = start_ops if solve == 7 else ((1 * MS, 2 * MS),)
        for k, (a, b) in enumerate(ops):  # launched inside CG_Start, run later
            launched.append([s0 + 1 * MS + k * 100 * US, s0 + 5 * MS + a, s0 + 5 * MS + b,
                             f"op{k}"])
        # the graph's kernels, launched from CG_Replay: not the start's
        launched.append([s0 + 5 * MS + 10 * US, s0 + 9 * MS, s0 + 39 * MS, "graph"])
    return {"spans": out, "window_ns": [100 * MS, 200 * MS], "launched": launched,
            "counts": {"solves": 2, "captures": 0}}


def test_start_reads_the_union_of_the_start_launches():
    # solve 7: [6, 7] and [6.5, 8] ms after its start, a union of 2 ms (a sum would be 2.5);
    # solve 8: 1 ms; the mean over the two traced solves
    assert spans.start_ms([_rank()]) == pytest.approx(1.5)
    # on ranks, the largest
    wide = _rank(start_ops=((0, 4 * MS),))
    assert spans.start_ms([_rank(), wide]) == pytest.approx(2.5)


def test_start_leaves_out_solves_outside_the_range():
    tr = _rank()
    tr["window_ns"] = [100 * MS, 149 * MS]  # solve 8 ends outside it
    assert spans.start_ms([tr]) == pytest.approx(2.0)


def test_skew_of_ranks_40_us_apart():
    traces = [_rank(), _rank(offset=40 * US), _rank(offset=10 * US)]
    assert spans.launch_skew_us(traces) == pytest.approx(40.0)
    assert spans.launch_skew_us(traces[:1]) is None  # one rank has no skew


def test_setup_spans():
    traces = [_rank(), _rank()]
    traces[1]["spans"][5][2] = 61 * MS  # rank 1's capture ran 12 ms longer
    assert spans.capture_s(traces) == pytest.approx(0.050)
    assert spans.group_s(traces) == pytest.approx(0.004)
    assert spans.setup_split(traces) == {"Kernel_Load": pytest.approx(0.002),
                                         "Operator_Build": pytest.approx(0.006),
                                         "NCCL_Group": pytest.approx(0.004),
                                         "CG_Capture": pytest.approx(0.050)}


def test_no_program_spans_read_none():
    bare = {"window_ns": [0, 10 * MS], "launched": [], "busy_s": 0.01}
    for traces in ([bare], [bare, bare], [{"busy_s": 0.01}] * 2, []):
        assert all(fn(traces) is None for fn in spans.READINGS.values())
        assert spans.setup_split(traces) == {}
    # a run whose spans hold no capture (an eager loop) has no capture_s either
    tr = _rank()
    tr["spans"] = [sp for sp in tr["spans"] if sp[0] != "CG_Capture"]
    assert spans.capture_s([tr]) is None and spans.start_ms([tr]) is not None


def test_timeline_and_idle_by_span():
    named = [("CG_Solver", 10, 90), ("CG_Start", 20, 30), ("CG_Read", 40, 90),
             ("Kernel_Load", 22, 25)]
    assert spans.timeline(named, 0, 100) == [
        (0, 10, "caller"), (10, 20, "CG_Solver"), (20, 22, "CG_Start"),
        (22, 25, "Kernel_Load"), (25, 30, "CG_Start"), (30, 40, "CG_Solver"),
        (40, 90, "CG_Read"), (90, 100, "caller")]
    gaps = [(5, 21), (85, 95)]
    got = spans.idle_by_span(named, gaps, 0, 100)
    assert got == {"caller": pytest.approx(10e-9), "CG_Solver": pytest.approx(10e-9),
                   "CG_Start": pytest.approx(1e-9), "CG_Read": pytest.approx(5e-9)}
    assert spans.idle_by_span([], gaps, 0, 100) == {"caller": pytest.approx(26e-9)}


def test_readings_collect_what_there_is():
    traces = [_rank(), _rank(offset=40 * US)]
    traces[0]["idle_by_span"] = {"CG_Read": 0.001}
    got = spans.readings(traces)
    assert set(got) == {"start_ms", "launch_skew_us", "capture_s", "group_s",
                        "setup_split_s", "idle_by_span_s", "counts"}
    assert got["idle_by_span_s"] == [{"CG_Read": 0.001}, {}]
    assert set(spans.readings([{"busy_s": 1.0}])) == {"setup_split_s", "idle_by_span_s",
                                                      "counts"}


@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_recorded_run_on_the_cpu(workload):
    from tpusparse_torch.bench import profiling

    cell = spec.cell(workload)
    plain = trace.traced
    record = spans.execute(cell, 2 ** 31 + 5, 0.2, True, time.time(), device="cpu", grid=24)
    assert trace.traced is plain and not profiling.record(False)  # both put back
    got = spans.line(cell, record, True, "cpu")
    assert got["correct"] and list(got)[-1] == "spans"
    s = got["spans"]
    ranks = cell.traffic["ranks"]
    assert len(s["counts"]) == ranks
    solves = cell.traffic["trace_solves"]
    assert all(c["solves"] == solves and c["captures"] == 0 for c in s["counts"])
    assert s["setup_split_s"]["Operator_Build"] > 0
    assert ("launch_skew_us" in s) == (ranks > 1) and s["start_ms"] == 0.0  # no card
    for tr, idle in zip(record["traces"], s["idle_by_span_s"]):
        # no device work: the whole range is idle, split between the spans (the CPU runs
        # the eager loops: their starts and phases) and the caller
        assert sum(idle.values()) == pytest.approx(tr["window_s"], rel=1e-6)
        assert min(idle.get(n, 0) for n in ("CG_Start", "SpMV", "caller")) > 0

"""The traced segment's reduction: the union of device intervals, idle gaps named by the
host's operation, device time by name and NCCL's apart."""

from __future__ import annotations

import pytest

from cgbench import trace


def test_union_clips_and_merges():
    spans = [(5, 10, "a"), (8, 12, "b"), (20, 30, "c"), (-5, 2, "d"), (28, 40, "e")]
    assert trace.merged(spans, 0, 35) == [(0, 2), (5, 12), (20, 35)]
    union = trace.merged(spans, 0, 35)
    assert trace.gaps(union, 0, 35) == [(2, 5), (12, 20)]
    assert trace.gaps([], 0, 10) == [(0, 10)]
    assert trace.idle_pct(2.0, 1.5) == pytest.approx(25.0)


def test_summarize():
    ms = 1_000_000
    spans = {
        "window": (0, 100 * ms),
        "device": [(12 * ms, 40 * ms, "k1"), (30 * ms, 60 * ms, "k2"),
                   (69 * ms, 90 * ms, "ncclDevKernel_AllGather"),
                   (-20 * ms, -10 * ms, "before")],
        "host": [(0, 15 * ms, "outer"), (55 * ms, 75 * ms, "cudaGraphLaunch"),
                 (58 * ms, 62 * ms, "aten::fill_")],
    }
    s = trace.summarize(spans)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.069)  # [12, 60] and [69, 90]
    # k1 and k2 overlap on [30, 40]: their device time is their union [12, 60], not what
    # ran before, and not the 58 ms of their sum, which only the breakdown's names add up
    assert s["compute_s"] == pytest.approx(0.048)
    assert s["ops"]["k1"] + s["ops"]["k2"] == pytest.approx(0.058)
    assert s["comm_s"] == pytest.approx(0.021)
    assert "before" not in s["ops"]
    # the gaps, longest first: [0, 12] during "outer", [90, 100] with no host op, [60, 69]
    # where aten::fill_ began last of the two under way
    assert s["gaps"] == [["outer", pytest.approx(0.012)],
                         ["host: no operation traced", pytest.approx(0.01)],
                         ["aten::fill_", pytest.approx(0.009)]]
    with pytest.raises(RuntimeError):
        trace.summarize({"window": None, "device": [], "host": []})


def test_overlapping_kernels_count_once():
    ms = 1_000_000
    spans = {"window": (0, 10 * ms),
             "device": [(0, 6 * ms, "piece0"), (1 * ms, 5 * ms, "piece1"),
                        (2 * ms, 7 * ms, "piece2"), (3 * ms, 4 * ms, "ncclDevKernel_SendRecv"),
                        (3 * ms, 9 * ms, "ncclDevKernel_AllGather")],
             "host": []}
    s = trace.summarize(spans)
    assert s["compute_s"] == pytest.approx(0.007)  # [0, 7], not 6 + 4 + 5 ms
    assert s["comm_s"] == pytest.approx(0.006)  # [3, 9]
    assert s["busy_s"] == pytest.approx(0.009)
    assert s["compute_s"] <= s["busy_s"]


def test_labels():
    assert trace.label("void (anonymous namespace)::k<double>(x)") == \
        "void__anonymous_namespace_::k_double__x_"
    assert len(trace.label("x" * 100)) == 64
    assert trace.is_comm("ncclDevKernel_SendRecv") and not trace.is_comm("spmv")

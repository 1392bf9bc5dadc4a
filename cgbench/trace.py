"""The traced run's device timeline, from ``torch.profiler``, reduced to what the
per-layer metrics and the ``breakdown`` read.

A traced segment is a few solves run back to back under the profiler inside one host range
(``WINDOW``), after the measured window has closed.  Its device intervals are every
operation the card ran (kernels, copies, fills; the profiler's own annotation ranges left
out).  Busy time is the union of those intervals within the range, idle time the rest of
the range; an idle gap is named by the innermost host operation that was running where it
began.  The device time of NCCL's kernels and of the rest is each the union of their
intervals, so operations that overlap on the card count once; the time by operation name,
which only the ``breakdown`` reads, is a sum.
"""

from __future__ import annotations

import re

import torch

WINDOW = "cgbench.traced_window"
_NO_HOST_OP = "host: no operation traced"


def prime(device) -> None:
    """Start and stop the profiler once on a card, before any CUDA graph is captured: the
    profiler sees a graph's kernels only if it ran before the capture."""
    if torch.device(device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize(device)


def traced(solve, solves: int, device) -> dict:
    """Run ``solves`` solves under the profiler, after one more that opens it, and
    summarize them (``summarize``), with the iterations they took."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    iterations = 0
    with profile(activities=activities) as prof:
        x, _ = solve()  # the profiler's own start-up falls outside the range
        del x
        with record_function(WINDOW):
            for _ in range(solves):
                x, stats = solve()
                iterations += stats.iterations
                del x
    summary = summarize(_spans(prof.profiler.kineto_results.events()))
    summary.update(solves=solves, iterations=iterations)
    return summary


def _spans(events) -> dict:
    """The profiler's events as plain spans in ns: the traced range, the device operations
    and the host operations, each (start, end, name)."""
    from torch.autograd import DeviceType

    window, device, host = None, [], []
    for e in events:
        span = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                window = span[:2]
            else:
                host.append(span)
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(span)
    return {"window": window, "device": device, "host": host}


def merged(intervals, lo, hi) -> list:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out = []
    for start, end, *_ in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def gaps(union, lo, hi) -> list:
    """The idle (start, end) stretches of [lo, hi] between the busy intervals ``union``."""
    out, at = [], lo
    for start, end in union:
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if hi > at:
        out.append((at, hi))
    return out


def _length(union) -> float:
    """The seconds that disjoint (start, end) ns intervals cover."""
    return sum(end - start for start, end in union) / 1e9


def idle_pct(window_s: float, busy_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def is_comm(name: str) -> bool:
    """Whether a device operation is NCCL's (its kernels are ``ncclDevKernel_*``)."""
    return name.startswith("nccl")


def label(name: str) -> str:
    """A kernel's or a host operation's name, cut to 64 characters of a plain set."""
    return re.sub(r"[^A-Za-z0-9_:.\-]", "_", name)[:64]


def _host_op(host, at) -> str:
    """The innermost host operation running at ``at``: of those under way, the one that
    began last."""
    best = None
    for start, end, name in host:
        if start <= at < end and (best is None or start > best[0]):
            best = (start, name)
    return _NO_HOST_OP if best is None else label(best[1])


def summarize(spans: dict, top: int = 10) -> dict:
    """The traced range's length and busy time, the device time of NCCL's kernels and of
    the rest (each a union of intervals), the device time by operation name, and the
    ``top`` longest idle gaps named by the host's operation, all in seconds and within the
    range."""
    if spans["window"] is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = spans["window"]
    union = merged(spans["device"], lo, hi)
    ops = {}
    for start, end, name in spans["device"]:
        s = (min(end, hi) - max(start, lo)) / 1e9
        if s > 0:
            ops[name] = ops.get(name, 0.0) + s
    comm = [d for d in spans["device"] if is_comm(d[2])]
    compute = [d for d in spans["device"] if not is_comm(d[2])]
    longest = sorted(gaps(union, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": _length(union),
        "compute_s": _length(merged(compute, lo, hi)),
        "comm_s": _length(merged(comm, lo, hi)),
        "ops": ops,
        "gaps": [[_host_op(spans["host"], start), (end - start) / 1e9]
                 for start, end in longest],
    }

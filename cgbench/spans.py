"""The program's own spans (``tpusparse_torch.bench.profiling``) read beside the traced
segment's device timeline, and a tool that runs a cell with the program recording them.

    python3 -m cgbench.spans --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs the cell as ``run.py`` does, with two differences.  Every process of the run turns
the program's recording on before set-up (``profiling.record(True)``), and the traced
segment is summarized by ``traced`` in place of ``trace.traced``: ``trace.summarize``'s
keys and, a rank,

  - ``spans``: the program's spans since the process started, set-up included, each
    [name, start_ns, end_ns, parent, solve id, attrs], on ``time.time_ns()``'s clock,
    which is the profiler's (Unix-epoch nanoseconds, one clock for every process of a
    host);
  - ``counts``: ``cg.COUNTS``'s change over the traced solves;
  - ``window_ns``: the traced range (``trace.WINDOW``), [start, end];
  - ``launched``: every device operation in the range whose launch the profiler saw, as
    [launch_ns, start_ns, end_ns, name]: the start of the runtime call (``cuda*``) that
    carries the operation's correlation id;
  - ``idle_by_span``: the range's idle seconds by the innermost program span open while
    the card idled (``CALLER`` where none was).

The result line is ``run.py``'s, with ``spans`` added: the readings below and the set-up
split.  Each reading takes the summaries, one a rank, and returns None where they hold
nothing to read (no program span):

  - ``start_ms``: the device time (union) of the operations launched inside a traced
    solve's ``CG_Start``, a solve; on several ranks the largest;
  - ``launch_skew_us``: for each solve id traced on every rank, the latest rank's
    ``CG_Solver`` start less the earliest's, the mean over those solves (several ranks);
  - ``capture_s``: the ``CG_Capture`` spans summed over the run, the slowest rank's;
  - ``group_s``: the ``NCCL_Group`` spans, the slowest rank's.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import trace  # noqa: E402

CALLER = "caller"  # idle time during which no program span was open
# the program's span names (``tpusparse_torch.bench.profiling``)
SOLVER, START, CAPTURE, GROUP = "CG_Solver", "CG_Start", "CG_Capture", "NCCL_Group"
SETUP = ("Kernel_Load", "Operator_Build", GROUP, CAPTURE)


# -- the readings ------------------------------------------------------------------------

def _closed(tr, name):
    """The closed spans called ``name`` of a rank's summary: [(start_ns, end_ns, solve)]."""
    return [(s, e, solve) for n, s, e, _parent, solve, _attrs in tr.get("spans", ())
            if n == name and e is not None]


def _inside(tr, name):
    """``_closed`` spans that lie within the rank's traced range."""
    lo, hi = tr["window_ns"]
    return [sp for sp in _closed(tr, name) if lo <= sp[0] and sp[1] <= hi]


def start_s(tr):
    """A rank's device seconds a traced solve launched from ``CG_Start``, or None."""
    starts = _inside(tr, START) if "window_ns" in tr else []
    if not starts:
        return None
    ops = [(s, e) for launch, s, e, _name in tr["launched"]
           if any(a <= launch < b for a, b, _solve in starts)]
    return sum(e - s for s, e in trace.merged(ops, *tr["window_ns"])) / 1e9 / len(
        {solve for _a, _b, solve in starts})


def start_ms(traces):
    got = [s for s in map(start_s, traces) if s is not None]
    return max(got) * 1e3 if got else None


def launch_skew_us(traces):
    if len(traces) < 2:
        return None
    firsts = []
    for tr in traces:
        firsts.append({solve: s for s, _e, solve in _inside(tr, SOLVER)}
                      if "window_ns" in tr else {})
    common = set.intersection(*(set(f) for f in firsts))
    if not common:
        return None
    return sum(max(f[i] for f in firsts) - min(f[i] for f in firsts)
               for i in common) / len(common) / 1e3


def _total_s(traces, name):
    got = [sum(e - s for s, e, _solve in _closed(tr, name)) / 1e9 for tr in traces
           if _closed(tr, name)]
    return max(got) if got else None


def capture_s(traces):
    return _total_s(traces, CAPTURE)


def group_s(traces):
    return _total_s(traces, GROUP)


def setup_split(traces) -> dict:
    """{span name: seconds} of set-up's spans (``SETUP``), each the slowest rank's sum;
    names no rank opened are left out."""
    out = {}
    for name in SETUP:
        value = _total_s(traces, name)
        if value is not None:
            out[name] = value
    return out


READINGS = {"start_ms": start_ms, "launch_skew_us": launch_skew_us,
            "capture_s": capture_s, "group_s": group_s}


def readings(traces) -> dict:
    """Every reading that finds something to read, the set-up split and, a rank, the idle
    split by span."""
    out = {name: fn(traces) for name, fn in READINGS.items()}
    out = {name: value for name, value in out.items() if value is not None}
    out["setup_split_s"] = setup_split(traces)
    out["idle_by_span_s"] = [tr.get("idle_by_span", {}) for tr in traces]
    out["counts"] = [tr.get("counts", {}) for tr in traces]
    return out


# -- the traced segment's summary, extended ------------------------------------------------

def timeline(spans, lo, hi) -> list:
    """[(start, end, name)] covering [lo, hi] in order: in each stretch the innermost of
    ``spans`` ((name, start, end), nested as scopes are) open there, ``CALLER`` where none
    was."""
    inside = [(max(s, lo), min(e, hi), n) for n, s, e in spans if s < hi and e > lo]
    cuts = sorted({lo, hi, *(s for s, _e, _n in inside), *(e for _s, e, _n in inside)})
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        open_ = [(s, -e, n) for s, e, n in inside if s <= a and b <= e]
        name = max(open_)[2] if open_ else CALLER  # the latest start; of two, the shorter
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def idle_by_span(spans, gaps, lo, hi) -> dict:
    """{span name: seconds} of the idle ``gaps`` ((start, end), sorted) by the innermost
    program span open (``timeline``)."""
    out = {}
    line = timeline(spans, lo, hi)
    j = 0
    for g0, g1 in gaps:
        while j < len(line) and line[j][1] <= g0:
            j += 1
        k = j
        while k < len(line) and line[k][0] < g1:
            a, b, name = line[k]
            s = (min(b, g1) - max(a, g0)) / 1e9
            if s > 0:
                out[name] = out.get(name, 0.0) + s
            k += 1
    return out


def extend(events, raw, spans, counts) -> dict:
    """The keys ``traced`` adds to a summary (this module's docstring), from the
    profiler's events, their plain spans (``trace._spans``), the program's spans
    (``profiling.spans()``) and ``cg.COUNTS``'s change."""
    from torch.autograd import DeviceType

    lo, hi = raw["window"]
    calls = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and not e.is_user_annotation() \
                and e.name().startswith("cuda") and e.correlation_id():
            calls[e.correlation_id()] = e.start_ns()
    launched = [[calls[e.correlation_id()], e.start_ns(), e.end_ns(), trace.label(e.name())]
                for e in events
                if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and e.correlation_id() in calls and e.end_ns() > lo and e.start_ns() < hi]
    closed = [(sp.name, sp.start_ns, sp.end_ns) for sp in spans if sp.end_ns is not None]
    gaps = trace.gaps(trace.merged(raw["device"], lo, hi), lo, hi)
    return {"spans": [[sp.name, sp.start_ns, sp.end_ns, sp.parent, sp.solve, sp.attrs]
                      for sp in spans],
            "counts": counts, "window_ns": [lo, hi], "launched": launched,
            "idle_by_span": idle_by_span(closed, gaps, lo, hi)}


def traced(solve, solves: int, device) -> dict:
    """``trace.traced``'s segment and summary, extended (``extend``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpusparse_torch.bench import profiling
    from tpusparse_torch.solvers import cg

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    iterations = 0
    with profile(activities=activities) as prof:
        x, _ = solve()  # the profiler's own start-up falls outside the range
        del x
        before = dict(cg.COUNTS)
        with record_function(trace.WINDOW):
            for _ in range(solves):
                x, stats = solve()
                iterations += stats.iterations
                del x
        counts = {k: v - before.get(k, 0) for k, v in cg.COUNTS.items()}
    events = list(prof.profiler.kineto_results.events())
    raw = trace._spans(events)
    summary = trace.summarize(raw)
    summary.update(solves=solves, iterations=iterations)
    summary.update(extend(events, raw, profiling.spans(), counts))
    return summary


# -- the tool --------------------------------------------------------------------------------

@contextlib.contextmanager
def recorded():
    """Inside the context, in this process: the program's recording on, and the traced
    segment extended (``traced`` in place of ``trace.traced``)."""
    from tpusparse_torch.bench import profiling

    was, plain = profiling.record(True), trace.traced
    trace.traced = traced
    try:
        yield
    finally:
        trace.traced = plain
        profiling.record(was)


def rank_run(r, dev, *args):
    """``ranks.rank_run`` with the program recording its spans (``recorded``)."""
    from . import ranks

    with recorded():
        return ranks.rank_run(r, dev, *args)


def start_ranks(cell, seed, seconds, traced_run, t_start, device="cuda", grid=None):
    """``harness.start_ranks`` on ``rank_run``."""
    from . import launch

    return launch.Ranks("cgbench.spans:rank_run", cell.traffic["ranks"],
                        (cell, seed, seconds, traced_run, t_start, grid, None), device)


def execute(cell, seed, seconds, traced_run, t_start, device="cuda", grid=None,
            started=None) -> dict:
    """``harness.execute`` with every process of the run recording the program's spans."""
    from . import harness

    if cell.traffic["ranks"] > 1 and started is None:
        started = start_ranks(cell, seed, seconds, traced_run, t_start, device, grid)
    with recorded():
        return harness.execute(cell, seed, seconds, traced_run, t_start, device=device,
                               grid=grid, started=started)


def line(cell, record, traced_run, platform="gpu") -> dict:
    """``harness.result``'s line, with the spans' readings under ``spans`` when traced."""
    from . import harness

    out = harness.result(cell, record, traced_run, record["kind"], platform)
    if traced_run:
        out["spans"] = readings(record["traces"])
    return out


def main(argv=None) -> int:
    from . import spec

    p = argparse.ArgumentParser(prog="python3 -m cgbench.spans", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    traced_run = bool(args.trace)
    # the ranks import torch while this process does
    started = (start_ranks(cell, args.seed, args.seconds, traced_run, T_START)
               if cell.traffic["ranks"] > 1 else None)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        if started is not None:
            started.stop(kill=True)
        print(f"[spans] {args.workload} needs {cell.chips} CUDA card(s), {have} visible",
              file=sys.stderr)
        return 2
    record = execute(cell, args.seed, args.seconds, traced_run, T_START, started=started)
    print(f"[spans] {args.workload} seed {args.seed}: {len(record['times_ms'])} solves, "
          f"set-up {record['setup_s']!r} s", file=sys.stderr, flush=True)
    print(json.dumps(line(cell, record, traced_run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

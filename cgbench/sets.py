"""Sets of runs of one cell, as a check of the benchmark makes them, and their spreads.

    python3 -m cgbench.sets --workload <name> --seeds 11,12,13,14,15,16 [--sets 2]
        [--seconds 25] [--trace 0] [--json PATH]

Runs ``BENCHMARK.json``'s command once a seed, one run after another, each set with the
same seeds, and prints every run's result line, then for each set and metric the median
and the spread (the distance between the first and third quartiles over the median,
``window.spread``), for all the runs and with the run farthest from the median left out.
``--seconds`` defaults to ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from . import spec, window


def one(command, workload, seed, seconds, traced) -> dict:
    """One run's result line, with its wall time and exit code."""
    t0 = time.time()
    proc = subprocess.run([*command, "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(traced)],
                          cwd=spec.ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    sys.stderr.write(proc.stderr[-4000:])
    return {"seed": seed, "rc": proc.returncode, "wall_s": time.time() - t0, "line": line}


def summary(runs) -> dict:
    """metric -> {median, spread, spread without the run farthest from the median}."""
    values = {}
    for run in runs:
        for name, m in (run["line"] or {}).get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
    out = {}
    for name, vs in values.items():
        med = statistics.median(vs)
        entry = {"median": med, "n": len(vs)}
        if len(vs) >= 2:
            entry["spread"] = window.spread(vs)
        if len(vs) >= 3:
            rest = sorted(vs, key=lambda v: abs(v - med))[:-1]
            entry["spread_less_farthest"] = window.spread(rest)
        out[name] = entry
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cgbench.sets", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    seeds = [int(s) for s in args.seeds.split(",")]
    sets, ok = [], True
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            run = one(bench["command"], args.workload, seed, seconds, args.trace)
            ok &= run["rc"] == 0 and bool(run["line"]) and run["line"]["correct"]
            print(json.dumps({"set": k, **run}), flush=True)
            runs.append(run)
        stats = summary(runs)
        print(json.dumps({"set": k, "workload": args.workload, "summary": stats}), flush=True)
        sets.append({"runs": runs, "summary": stats})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"workload": args.workload, "seconds": seconds, "sets": sets}, f,
                      indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

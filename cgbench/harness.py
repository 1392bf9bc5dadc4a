"""One run of one cell: ``python3 cgbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.

The cell's configuration, traffic and metrics are found by name (``spec``); a traffic of
one rank runs in this process (``single``), one of several ranks in as many spawned
processes (``ranks``).  With ``--trace 0`` the result line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each computed by its reader in
``metrics/`` from the run's record (``Run``); a reader that finds nothing to read returns
None and its metric is left out.  The last line of standard output is the result, a JSON
object whose last key, ``checks``, holds each number compared beside its limit; the same
numbers are the last lines of standard error.

The run fails, printing no result, when there is no card or fewer than the cell asks for,
and when, after the window, this process or a rank holds a module of JAX or of the JAX
package (``leaked``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from . import launch, smi, spec

# the top-level module names that no process of a run may hold: JAX and the JAX package
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "tpusparse"))


def leaked() -> list:
    """The forbidden top-level names among this process's modules (the part of each name
    before the first dot, compared whole)."""
    return sorted({name.partition(".")[0] for name in sys.modules} & FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell, the card, the set-up timers, the window's
    solves (rank 0's on several ranks) and the traced segment's summary a rank."""

    cell: spec.Cell
    kind: str  # the card's name, as torch.cuda.get_device_name gives it
    itemsize: int  # bytes of a word of the configuration's state
    points: list  # grid points a rank (one entry on one card)
    setup_s: float
    operator_build_s: float
    first_solve_s: float
    times_ms: list
    total_s: float
    iterations: list
    traces: list  # trace.traced's summary a rank, in rank order; empty untraced


def start_ranks(cell, seed: int, seconds: float, traced: bool, t_start: float,
                device: str = "cuda", grid: int | None = None, wrap=None) -> launch.Ranks:
    """The ranks of a run of a cell of several ranks (``ranks.rank_run`` each), started;
    ``wrap`` (tests: a function importable by name) takes each rank's timed solve and
    returns the one to run."""
    return launch.Ranks("cgbench.ranks:rank_run", cell.traffic["ranks"],
                        (cell, seed, seconds, traced, t_start, grid, wrap), device)


def execute(cell, seed: int, seconds: float, traced: bool, t_start: float,
            device: str = "cuda", grid: int | None = None, wrap=None, started=None) -> dict:
    """The run's record from the module the traffic asks for (``single`` or ``ranks``);
    ``started``: the run's ranks, already started (``start_ranks``)."""
    if cell.traffic["ranks"] > 1:
        from . import ranks

        if started is None:
            started = start_ranks(cell, seed, seconds, traced, t_start, device, grid, wrap)
        return ranks.finish(started, t_start)
    from . import single

    return single.run(cell, seed, seconds, traced, t_start, device=device, grid=grid,
                      wrap=wrap)


def checks(cell, record: dict) -> dict:
    """name -> (value, limit) of every number compared."""
    limits = cell.config["limits"]
    return {"x_err": (record["gap"] / record["scale"], limits["x_err"]),
            "iters_gap": (record["iters_gap"], limits["iters_gap"])}


def _breakdown(traces: list) -> dict:
    from . import trace

    ops = {}
    for tr in traces:
        for name, s in tr["ops"].items():
            ops[name] = ops.get(name, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    prefix = (lambda r: f"rank {r}: ") if len(traces) > 1 else (lambda r: "")
    gaps = sorted(([prefix(r) + name, s] for r, tr in enumerate(traces)
                   for name, s in tr["gaps"]), key=lambda g: -g[1])[:10]
    return {"device_ops": [[trace.label(n), s] for n, s in top], "idle_gaps": gaps}


def result(cell, record: dict, traced: bool, kind: str, platform: str) -> dict:
    """The result line of a run whose record is ``record``."""
    from . import check, inputs

    itemsize = inputs.DTYPES[cell.config["dtype"]].itemsize
    run = Run(cell, kind, itemsize, record["points"], record["setup_s"],
              record["operator_build_s"], record["first_solve_s"], record["times_ms"],
              record["total_s"], record["iterations"], record["traces"])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = checks(cell, record)
    attempted = len(record["times_ms"])
    device = {"platform": platform, "kind": kind, "count": cell.chips,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    line = {"correct": check.judge(compared) and record["failed"] == 0 and attempted > 0,
            "attempted": attempted, "failed": record["failed"], "metrics": metrics,
            "device": device}
    if traced:
        traces = record["traces"]
        device["busy_s"] = sum(tr["busy_s"] for tr in traces) / len(traces)
        device["window_s"] = sum(tr["window_s"] for tr in traces) / len(traces)
        line["breakdown"] = _breakdown(traces)
    line["checks"] = check.as_json(compared)
    return line


def _args(argv):
    p = argparse.ArgumentParser(prog="cgbench/run.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(f"[cgbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    """Run one cell once on the card(s); 0 with a result line, else non-zero without."""
    import time

    t_start = time.time() if t_start is None else t_start
    args = _args(argv)
    cell = spec.cell(args.workload)
    traced = bool(args.trace)
    # the ranks import torch while this process does
    started = (start_ranks(cell, args.seed, args.seconds, traced, t_start)
               if cell.traffic["ranks"] > 1 else None)
    import torch

    from . import check

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        if started is not None:
            started.stop(kill=True)
        _log(f"{args.workload} needs {cell.chips} CUDA card(s), {have} visible: no result")
        return 2
    record = execute(cell, args.seed, args.seconds, traced, t_start, started=started)
    bad = sorted(set(leaked()) | set(record.get("leaked", ())))
    if bad:
        _log(f"the run loaded {bad}: no module of JAX or of the JAX package may run: "
             "no result")
        return 3
    line = result(cell, record, traced, record["kind"], "gpu")
    cards = smi.cards()
    _log(f"{args.workload} seed {args.seed}: {len(record['times_ms'])} solves in "
         f"{record['total_s']!r} s, iterations {sorted(set(record['iterations']))}, "
         f"set-up {record['setup_s']!r} s; solve {record['kept_index']} checked "
         f"({record['kept_iterations']} iterations, the reference's {record['ref_iterations']}) "
         f"[{'; '.join(cards[:cell.chips]) or record['kind']}]")
    _log("set-up, seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in record["setup_phases"].items()))
    _log(f"nvidia-smi index, clocks.sm MHz, clocks.mem MHz, power.draw W, temperature C "
         f"over the window: {record['smi']}")
    for text in check.lines(checks(cell, record)):
        print(text, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0

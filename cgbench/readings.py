"""The readings a cell's limit is set from: ``x_err`` of one solve a seed, by the program
as the configuration states it (the lower reading: sound runs) or in the configuration's
``control_dtype`` (the upper reading: the control, the program's own lower-precision path;
a bf16 state runs the classic loop, the only one the program has for it).

    python3 -m cgbench.readings --workload <name> --seeds 1,2,3 [--control]

Each solve is the first of its b on an operator built once, through the entry the window
drives.  Prints a line a seed on stderr and, last on stdout, a JSON object with every
reading.  Needs the cell's cards, as a run does.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from . import check, inputs, launch, ranks, single, spec
from .reference import cg as reference

DEADLINE_S = 3000.0


def _readings(prog, cell, seeds, dev, grid, rows=None) -> list:
    """[(seed, max|x − x_ref| over the field or the band, max|x_ref|, iterations, the
    reference's iterations)] for each seed."""
    c = cell.config
    problem = cell.problem()
    shape = problem.shape(c, grid)
    apply = functools.partial(problem.apply, config=c)
    out = []
    for seed in seeds:
        b = inputs.right_hand_side(shape, seed, inputs.DTYPES[c["dtype"]], dev,
                                   cell.traffic["b"])
        x, stats = prog.solve(b)
        x_ref, ref_iters = reference.solve(b, apply, c["tolerance"], c["max_iters"])
        part = x if rows is None else x[:rows[1] - rows[0]]
        out.append((seed, check.field_gap(part, x_ref, rows), check.scale(x_ref),
                    stats.iterations, ref_iters))
        del x, x_ref, b
    return out


def rank_readings(r, dev, cell, seeds, dtype, grid):
    """A rank's readings (``collect``)."""
    prog = ranks.RankProgram(cell, dev, dtype=dtype, grid=grid)
    return _readings(prog, cell, seeds, dev, grid, prog.rows)


def collect(cell, seeds, dtype: str | None = None, device: str = "cuda",
            grid: int | None = None) -> list:
    """[{"seed", "x_err", "iterations", "ref_iterations"}] of the program in ``dtype``
    (the configuration's by default) on each seed."""
    if cell.traffic["ranks"] > 1:
        started = launch.Ranks("cgbench.readings:rank_readings", cell.traffic["ranks"],
                               (cell, seeds, dtype, grid), device)
        ok = False
        try:
            every = started.collect(time.time() + DEADLINE_S)
            ok = True
        finally:
            started.stop(kill=not ok)
        rows = [(s, max(r[i][1] for r in every), sc, k, kr)
                for i, (s, _, sc, k, kr) in enumerate(every[0])]
    else:
        dev = torch.device(device)
        rows = _readings(single.Program(cell, dev, dtype=dtype, grid=grid), cell, seeds, dev,
                         grid)
    return [{"seed": s, "x_err": gap / sc, "iterations": k, "ref_iterations": kr}
            for s, gap, sc, k, kr in rows]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cgbench.readings", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    p.add_argument("--control", action="store_true",
                   help="the program in the configuration's control_dtype")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"[readings] {args.workload} needs {cell.chips} CUDA card(s), {have} visible",
              file=sys.stderr)
        return 2
    dtype = cell.config["control_dtype"] if args.control else cell.config["dtype"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = collect(cell, seeds, dtype)
    for row in out:
        print(f"[readings] {args.workload} {dtype} seed {row['seed']}: x_err "
              f"{row['x_err']!r}, iterations {row['iterations']} (reference "
              f"{row['ref_iterations']})", file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "dtype": dtype, "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

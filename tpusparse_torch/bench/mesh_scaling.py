"""The sharded CG's mesh across cards against the same mesh of shards on one card.

    python -m tpusparse_torch.bench.mesh_scaling [--grid 20480] [--runs 5] [--json PATH]
        [--platform cuda|cpu]

For each case (mesh shape, mode, dtype) the mesh is built twice
(``cg_sharded.make_mesh_operator``): one shard a card (``dist.make_mesh`` over cards 0 to
n − 1; the eager loop, its flag read once an iteration), and every shard on card 0 (one
CUDA graph replay a solve).  Each solves once, then ``--runs`` times; printed: both
medians and their ratio, the iterations, the host reads and replays a solve
(``cg.COUNTS``), and whether x is the same bit for bit (it must be: the same kernels on
the same shards, the dots added in shard order).  Needs as many cards as the largest
mesh (4) and exits 1 with fewer, or when an x differs.  ``--platform=cpu`` runs both
meshes on the CPU (a rehearsal of the code path; its times say nothing of a card).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

from .. import dist
from .._device import resolve_dtype
from ..solvers import cg, cg_sharded
from . import sysinfo

# (mesh shape, mode, dtype)
CASES = (((4,), "stencil5", "f64"), ((4,), "stencil5-const", "f32"), ((2, 2), "stencil5", "f64"),
         ((2,), "stencil5", "f64"), ((4,), "csr", "f64"), ((2,), "stencil5", "bf16"))


def _solve(mesh, g, mode, dtype, runs):
    """(x on the host, iterations, median ms, cg.COUNTS a solve, whether the loop ran from
    a graph) of ``runs`` solves after a first one."""
    op = cg_sharded.make_mesh_operator(g, mesh, mode=mode, dtype=dtype)
    xs, s = op.solve()
    x = op.assemble(xs).cpu()
    del xs
    cg.reset_counts()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        op.solve()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v / runs for k, v in cg.COUNTS.items()}
    graphed = op.one_card
    del op
    cg_sharded.clear_caches()
    for d in {d for d in mesh.devices if d.type == "cuda"}:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return x, s.iterations, statistics.median(times), counts, graphed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.mesh_scaling",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", type=int, default=20480)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--json", default=None)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(math.prod(shape) for shape, _m, _d in CASES)
    if args.platform == "cuda" and cards < need:
        print(f"mesh_scaling: needs {need} CUDA cards, {cards} visible (or --platform=cpu)",
              file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi() if args.platform == "cuda" else "cpu"
    one = "cuda:0" if args.platform == "cuda" else "cpu"
    rows, ok = [], True
    for shape, mode, dtype_name in CASES:
        axes = ("x", "y")[:len(shape)]
        spread = dist.make_mesh(shape, axes, devices=args.platform)
        shared = dist.make_mesh(shape, axes, devices=[one])
        dtype = resolve_dtype(dtype_name)
        xa, ka, ma, ca, ga = _solve(spread, args.grid, mode, dtype, args.runs)
        xb, kb, mb, cb, gb = _solve(shared, args.grid, mode, dtype, args.runs)
        same = ka == kb and torch.equal(xa, xb)
        ok &= same
        split = "x".join(map(str, shape))
        print(f"[mesh scaling] {args.grid}² {split} {mode} {dtype_name}: on "
              f"{[str(d) for d in spread.devices]} {ka} iterations, median {ma!r} ms "
              f"({'graph' if ga else 'eager'}, {ca} a solve); every shard on {one}: {kb} "
              f"iterations, median {mb!r} ms ({'graph' if gb else 'eager'}, {cb} a solve); "
              f"one card / cards {mb / ma!r}; x bit for bit: {same} [{smi}]", flush=True)
        rows.append({"grid": args.grid, "mesh": list(shape), "mode": mode,
                     "dtype": dtype_name, "devices": [str(d) for d in spread.devices],
                     "iterations": [ka, kb], "median_ms": [ma, mb], "counts": [ca, cb],
                     "graph": [ga, gb], "x_equal": same, "card": smi})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

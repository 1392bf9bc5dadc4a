"""What the sharded classic loop's overlapped SpMV buys: overlap=True against overlap=False.

    python -m tpusparse_torch.bench.sharded_overlap [--grid 20480] [--ranks 2,4]
        [--modes stencil5,stencil5-const] [--dtype f64] [--reps 3] [--json PATH]
        [--transport mesh|gloo] [--platform cuda|cpu]

For each shard count N (``--ranks``) both operators of each mode are built at g² (the
overlapped one keeps a band's planes in three row pieces) and ``cg_solve_sharded``'s
classic loop (``recompute_ap=False``, b = ones) runs with each, one warm-up solve apiece,
then ``--reps`` rounds of overlapped / synchronous / synchronous / overlapped.  The
transport: ``mesh`` (the default), an N-shard mesh in this process (on one card the
shards share it and the loop is one graph replay, so the overlap can only regroup the
dots), each solve timed to its end (the read that ends it); ``gloo``, N gloo ranks
(``dist.launch_local``), a solve's time the slowest rank's, each rank timing from a
barrier to the end of its solve (``torch.cuda.synchronize``), where the overlap hides the
host's halo exchange behind the interior rows' kernel.  Both must take the same
iterations and give the same x to 1e-12 relative (the dots group their sums differently).
Prints the medians and their ratio with the transport and the card's name and power
limit; ``--json`` keeps every solve's time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .. import dist
from .._device import resolve_dtype
from ..solvers import cg_sharded
from . import sysinfo


def _compare(modes, reps, make, solve, gather):
    """{mode: {"overlap": [ms], "sync": [ms], "iterations": (k, k), "rel_diff": max |x_o −
    x_s| / max |x_s|}}: ``make(mode, overlap)`` builds an operator, ``solve(op)`` gives
    (x, CGStats, ms), ``gather(v)`` the list of v over the ranks (a mesh's: [v])."""
    out = {}
    for mode in modes:
        ops = {name: make(mode, name == "overlap") for name in ("overlap", "sync")}
        xs = {name: solve(ops[name])[:2] for name in ops}  # the warm-ups
        (xo, so), (xsync, ssync) = xs["overlap"], xs["sync"]
        diff = gather((float((xo - xsync).abs().max()), float(xsync.abs().max())))
        del xs, xo, xsync
        times = {"overlap": [], "sync": []}
        for _ in range(reps):
            for name in ("overlap", "sync", "sync", "overlap"):
                times[name].append(solve(ops[name])[2])
        out[mode] = {**times, "iterations": (so.iterations, ssync.iterations),
                     "rel_diff": max(d for d, _ in diff) / max(m for _, m in diff)}
        del ops
        cg_sharded.clear_caches()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _rank(device, g, modes, dtype, reps):
    """This gloo rank's solves; rank 0 returns ``_compare``'s dict."""
    def make(mode, overlap):
        return cg_sharded.make_sharded_operator(g, mode=mode, dtype=dtype, overlap=overlap,
                                                device=device)

    def solve(op):
        dist.barrier()
        t0 = time.perf_counter()
        x, s = cg_sharded.cg_solve_sharded(g, operator=op, recompute_ap=False)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x, s, max(dist._all_objects((time.perf_counter() - t0) * 1e3))

    return _compare(modes, reps, make, solve, dist._all_objects)


def _mesh(n, platform, g, modes, dtype, reps):
    """The solves on an n-shard mesh in this process: ``_compare``'s dict."""
    mesh = dist.make_band_mesh(n, devices=platform)

    def make(mode, overlap):
        return cg_sharded.make_mesh_operator(g, mesh, mode=mode, dtype=dtype, overlap=overlap)

    def solve(op):
        t0 = time.perf_counter()
        xs, s = op.solve(recompute_ap=False)  # ends in the read of its result
        ms = (time.perf_counter() - t0) * 1e3
        return op.assemble(xs), s, ms

    return _compare(modes, reps, make, solve, lambda v: [v])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.sharded_overlap",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", type=int, default=20480)
    p.add_argument("--ranks", default="2,4")
    p.add_argument("--modes", default="stencil5,stencil5-const")
    p.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--json", default=None)
    p.add_argument("--transport", default="mesh", choices=["mesh", "gloo"],
                   help="the shards of a mesh in this process, or gloo ranks")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("sharded_overlap: needs a CUDA card (or --platform=cpu)", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi() if args.platform == "cuda" else "cpu"
    modes = args.modes.split(",")
    rows, ok = [], True
    dtype = resolve_dtype(args.dtype)
    who = "shards (mesh)" if args.transport == "mesh" else "ranks (gloo)"
    for n in (int(s) for s in args.ranks.split(",")):
        got = (_mesh(n, args.platform, args.grid, modes, dtype, args.reps)
               if args.transport == "mesh"
               else dist.launch_local(_rank, n, args.grid, modes, dtype, args.reps,
                                      device=args.platform))
        for mode, r in got.items():
            mo, ms = statistics.median(r["overlap"]), statistics.median(r["sync"])
            right = r["iterations"][0] == r["iterations"][1] and r["rel_diff"] <= 1e-12
            ok &= right
            rows.append({"grid": args.grid, "ranks": n, "transport": args.transport,
                         "mode": mode, "dtype": args.dtype,
                         **r, "overlap_median_ms": mo, "sync_median_ms": ms, "card": smi})
            print(f"[overlap] g={args.grid} {args.dtype} {mode} on {n} {who}: overlapped "
                  f"median {mo!r} ms, synchronous {ms!r} ms (overlapped/synchronous "
                  f"{mo / ms!r}; {args.reps} rounds); iterations {r['iterations']}, x rel diff "
                  f"{r['rel_diff']:.3e} ({'right' if right else 'WRONG'}) [{smi}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

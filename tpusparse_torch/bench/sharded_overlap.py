"""What the sharded classic loop's overlapped SpMV buys: overlap=True against overlap=False.

    python -m tpusparse_torch.bench.sharded_overlap [--grid 20480] [--ranks 2,4]
        [--modes stencil5,stencil5-const] [--dtype f64] [--reps 3] [--json PATH]
        [--platform cuda|cpu]

For each rank count N, N ranks (``dist.launch_local``; with one card they share it) build
both operators of each mode at g² (the overlapped one keeps a band's planes in three row
pieces) and run ``cg_solve_sharded``'s classic loop (``recompute_ap=False``, b = ones)
with each, one warm-up solve apiece, then ``--reps`` rounds of overlapped / synchronous /
synchronous / overlapped.  A solve's time is the slowest rank's, each rank timing from a
barrier to the end of its solve (``torch.cuda.synchronize``).  Both must take the same
iterations and give the same x to 1e-12 relative (the dots group their sums differently).
Prints the medians and their ratio with the card's name and power limit; ``--json`` keeps
every solve's time.
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


def _rank(device, g, modes, dtype, reps):
    """This rank's solves; rank 0 returns {mode: {"overlap": [ms], "sync": [ms],
    "iterations": k, "rel_diff": max |x_o − x_s| / max |x_s| over the ranks}}."""
    out = {}
    for mode in modes:
        ops = {name: cg_sharded.make_sharded_operator(g, mode=mode, dtype=dtype,
                                                      overlap=name == "overlap", device=device)
               for name in ("overlap", "sync")}

        def solve(name):
            dist.barrier()
            t0 = time.perf_counter()
            x, s = cg_sharded.cg_solve_sharded(g, operator=ops[name], recompute_ap=False)
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return x, s, max(dist._all_objects((time.perf_counter() - t0) * 1e3))

        xs = {name: solve(name)[:2] for name in ops}  # the warm-ups
        (xo, so), (xsync, ssync) = xs["overlap"], xs["sync"]
        diff = dist._all_objects((float((xo - xsync).abs().max()), float(xsync.abs().max())))
        del xs, xo, xsync
        times = {"overlap": [], "sync": []}
        for _ in range(reps):
            for name in ("overlap", "sync", "sync", "overlap"):
                times[name].append(solve(name)[2])
        out[mode] = {**times, "iterations": (so.iterations, ssync.iterations),
                     "rel_diff": max(d for d, _ in diff) / max(m for _, m in diff)}
        del ops
        cg_sharded.clear_caches()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


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
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("sharded_overlap: needs a CUDA card (or --platform=cpu)", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi() if args.platform == "cuda" else "cpu"
    modes = args.modes.split(",")
    rows, ok = [], True
    for n in (int(s) for s in args.ranks.split(",")):
        got = dist.launch_local(_rank, n, args.grid, modes, resolve_dtype(args.dtype),
                                args.reps, device=args.platform)
        for mode, r in got.items():
            mo, ms = statistics.median(r["overlap"]), statistics.median(r["sync"])
            right = r["iterations"][0] == r["iterations"][1] and r["rel_diff"] <= 1e-12
            ok &= right
            rows.append({"grid": args.grid, "ranks": n, "mode": mode, "dtype": args.dtype,
                         **r, "overlap_median_ms": mo, "sync_median_ms": ms, "card": smi})
            print(f"[overlap] g={args.grid} {args.dtype} {mode} on {n} ranks: overlapped "
                  f"median {mo!r} ms, synchronous {ms!r} ms (overlapped/synchronous "
                  f"{mo / ms!r}; {args.reps} rounds); iterations {r['iterations']}, x rel diff "
                  f"{r['rel_diff']:.3e} ({'right' if right else 'WRONG'}) [{smi}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

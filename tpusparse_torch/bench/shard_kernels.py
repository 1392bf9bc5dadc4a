"""A kernel on one whole field against the same kernel on the N shards of a mesh.

    python -m tpusparse_torch.bench.shard_kernels [--grid 20480] [--shards 4] [--reps 20]
        [--json PATH] [--platform cuda|cpu]

The mesh's solves on one card run every kernel N times on fields of g/N rows where the
single-device solve runs it once on g rows (``solvers.cg_sharded.MeshLoop``).  For K4 and
K5 (f64), K8 with its dot (f64, and a bf16 state), K1 and K2 (f32), each on seeded
fields made on the card, this times one pass over the whole (g, g) field and one pass
over N separately allocated (g/N, g) fields, each pass a CUDA graph replayed ``--reps``
times between CUDA events (its buffers recorded by an eager pass, as the graph loop
records its body's), in turns: whole, shards, shards, whole.  Prints both times, their
ratio and the card's name and power limit.  ``--platform=cpu`` runs the passes on the
host clock (a rehearsal; its times say nothing of a card).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .._device import resolve_device
from ..kernels import _launch, blas1
from ..kernels import stencil5 as st5
from . import sysinfo

KW = {"diag": 5.0, "offdiag": -1.0}


def _passes():
    """kernel -> (state dtype, planes or None, fn(fields, planes) launching it once)."""
    a = 0.37
    return {
        "K4 f64": (torch.float64, False, lambda f, _p: blas1.cg_update(a, *f[:4])),
        "K5 f64": (torch.float64, False, lambda f, _p: blas1.p_update(a, f[0], f[1])),
        "K8 f64": (torch.float64, True,
                   lambda f, p: st5.spmv_stencil5(p, f[0], with_dot=True, out=f[1])),
        "K8 bf16": (torch.bfloat16, True,
                    lambda f, p: st5.spmv_stencil5(p, f[0], with_dot=True, out=f[1])),
        "K1 f32": (torch.float32, False, lambda f, _p: st5.spmv_stencil5_const_pupdate_dot(
            a, f[0], f[1], out=f[2], **KW)),
        "K2 f32": (torch.float32, False, lambda f, _p: st5.cg_const_update_recompute(
            a, f[0], f[1], f[2], **KW)),
    }


def _pass_ms(run, device, reps):
    """Milliseconds of one ``run()``: a CUDA graph of it replayed ``reps`` times between
    CUDA events on a card, the host clock over ``reps`` calls on the CPU."""
    if device.type != "cuda":
        run()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        return (time.perf_counter() - t0) * 1e3 / reps
    ws = _launch.Workspace(device)
    with _launch.set_apart(), _launch.use(ws):
        run()
    graph = torch.cuda.CUDAGraph()
    with _launch.set_apart(), torch.cuda.graph(graph), _launch.use(ws):
        ws.rewind()
        run()
    graph.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.shard_kernels",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", type=int, default=20480)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--json", default=None)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.platform)
    g, n = args.grid, args.shards
    if g % n:
        print(f"shard_kernels: --grid {g} must divide by --shards {n}", file=sys.stderr)
        return 2
    smi = sysinfo.nvidia_smi() if device.type == "cuda" else "cpu"
    gen = torch.Generator(device=device).manual_seed(14)
    rows = []
    for name, (dtype, with_planes, launch) in _passes().items():
        def field(r):
            return torch.rand((r, g), generator=gen, device=device).to(dtype)

        def planes(r):
            return torch.rand((5, r, g), generator=gen, device=device).to(dtype)

        whole = ([field(g) for _ in range(4)], planes(g) if with_planes else None)
        parts = [([field(g // n) for _ in range(4)], planes(g // n) if with_planes else None)
                 for _ in range(n)]
        runs = {"whole": lambda: launch(*whole),
                "shards": lambda: [launch(*part) for part in parts]}
        times = {"whole": [], "shards": []}
        for which in ("whole", "shards", "shards", "whole"):
            times[which].append(_pass_ms(runs[which], device, args.reps))
        w, s = (statistics.median(times[k]) for k in ("whole", "shards"))
        print(f"[shard kernels] {name} at {g}²: one field {w!r} ms, {n} fields of {g // n} "
              f"rows {s!r} ms (shards / whole {s / w!r}) [{smi}]", flush=True)
        rows.append({"kernel": name, "grid": g, "shards": n, "whole_ms": w, "shards_ms": s,
                     "card": smi})
        del whole, parts, runs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

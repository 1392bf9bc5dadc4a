"""The sharded CG's mesh across cards, in its two loops, against the same mesh of shards on
one card.

    python -m tpusparse_torch.bench.mesh_scaling [--grid 20480] [--runs 5] [--json PATH]
        [--platform cuda|cpu] [--profile] [--per-card K] [--ranks W]

For each case (mesh shape, mode, dtype) the mesh is built twice
(``cg_sharded.make_mesh_operator``): one shard a card (``dist.make_mesh`` over cards 0 to
n − 1), and every shard on card 0.  ``--per-card K`` runs the row-band cases with K times
the shards instead, K a card (shard i on card i % (n / K), as ``dist.make_mesh`` places
more shards than cards).  Three loops solve it: across the cards the per-card loop
(``per_shard=True``, graph=None's choice there: a CUDA graph a card, its shards in
lockstep, replayed on its card, one replay a card and one read a solve) and the eager
loop (``graph=False``, its flag read once an iteration), in turns; on card 0 the mesh's
one graph (one replay and one read a solve).  Each loop solves once, then ``--runs``
times; printed: the three medians, the per-card loop's speed-up over the eager loop and
over the one card, the iterations, the host reads and replays a solve (``cg.COUNTS``),
and whether x is the same bit for bit in all three (it must be: the same kernels on the
same shards, the dots added in shard order on every card); and the time of one dot sync
point across the cards (``_sync_us``).  ``--profile`` adds one profiled per-card solve a
case: each card's device time in the sync kernels (mostly their waits) and in the rest.
Needs as many cards as the largest mesh (4) and exits 1 with fewer, or when an x
differs.  ``--platform=cpu`` runs every mesh on the CPU, the per-card
loop on the kernels' twins (a rehearsal of the code path; its times say nothing of a
card).

``--ranks W`` runs the rank cases of W ranks instead (``RANK_CASES``), each in a group of
W processes spawned by ``dist.launch_local``, rank r on card r: one band or block a rank
(W = the shards), or a mesh across the ranks (``dist.make_rank_mesh``; 2 ranks × 2 cards
each: a rank's own shards meet card to card).  Each solves in three legs on the same
cards (``RANK_LEGS``): over NCCL (``dist.device_group``) from CUDA graphs (``graph`` None:
one graph a rank where the rank's shards sit on one card, ``MeshLoop``; one graph a card
where they sit on several, ``RankCardLoop``, NCCL's calls in the home card's graph), over
NCCL eagerly (``graph=False``, the flag read once an iteration) and over gloo through the
host (``transport="gloo"``): a first solve, then ``--runs`` solves each after a barrier (a
solve's time the slowest rank's).  Beside them the same shards as one process's mesh over
the cards, its per-card and eager loops.  Printed: the five medians, the transport each
leg ran, each rank's host reads and replays a solve (``cg.COUNTS``: in the graph leg one
read, and one replay a card of the rank), the iterations, and whether x is the same bit
for bit in every leg (each shard's bytes by sha256).  With ``--platform=cpu`` the ranks
are gloo's and the graph leg is left out (graph=None runs the eager loop there).
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
# the loops: label -> MeshOperator.solve's arguments; the first two run across the cards
LOOPS = {"per card": {"per_shard": True}, "eager": {"graph": False}, "one card": {}}
# dot sync points (a publish and a wait that sums) in the graph a shard that times one
SYNC_REPS = 1000
# the rank cases: label -> (ranks, shards: N bands or an (R, C) mesh, mode, dtype); the
# shards one a rank, or a mesh across the ranks; shard i on card i either way
RANK_CASES = {
    "stencil5 f64, 4 bands": (4, 4, "stencil5", "f64"),
    "const f32 recompute, 4 bands": (4, 4, "stencil5-const", "f32"),
    "2x2 stencil5 f64": (4, (2, 2), "stencil5", "f64"),
    "rank mesh 4 bands stencil5 f64": (2, 4, "stencil5", "f64"),
    "rank mesh 2x2 stencil5 f64": (2, (2, 2), "stencil5", "f64"),
}
# the legs a rank case runs: label -> (dist.device_group's transport, the solve's graph):
# over NCCL from CUDA graphs (graph=None's choice there: one a rank, or one a card of the
# rank; run only where it is a graph) and eagerly, over gloo eagerly (the host steps it)
RANK_LEGS = {"graph": (None, None), "nccl": (None, False), "gloo": ("gloo", False)}


def _solve(op, runs, loops):
    """{loop: (x on the host, iterations, median ms, cg.COUNTS a solve)} of each loop
    (``LOOPS``' labels) on ``op``: a first solve each, then ``runs`` rounds of one solve
    a loop, in turns."""
    first, times = {}, {name: [] for name in loops}
    counts = {name: dict.fromkeys(cg.COUNTS, 0) for name in loops}
    for name in loops:
        xs, s = op.solve(**LOOPS[name])
        first[name] = (op.assemble(xs).cpu(), s.iterations)
        del xs
    for r in range(runs):
        for name in (loops if r % 2 == 0 else loops[::-1]):
            cg.reset_counts()
            t0 = time.perf_counter()
            op.solve(**LOOPS[name])
            times[name].append((time.perf_counter() - t0) * 1e3)
            for k, v in cg.COUNTS.items():
                counts[name][k] += v / runs
    return {name: (*first[name], statistics.median(times[name]), counts[name])
            for name in loops}


def _sync_us(devices, reps=SYNC_REPS):
    """µs of one dot sync point of the per-card loop on ``devices``, one shard a card:
    each shard publishes a f64 partial into every shard's slots, then waits for all of
    them and adds them (``kernels/mesh_sync.py``).  A CUDA graph of ``reps`` sync points a
    shard, every shard's replayed at once on its own stream, timed on the host clock from
    the launches to the last card's end (after a first replay); each sync point waits for
    every shard's publish of it, so this is the round trip the loop pays three times an
    iteration.  Raises if a wait gave up or a sum is wrong.  The cards must be distinct:
    this times the round trip between cards."""
    from ..kernels import graph as graph_kernels
    from ..kernels import mesh_sync

    n = len(devices)
    if len(set(devices)) != n:
        raise ValueError(f"one shard a card, got {devices}")
    cg_sharded._enable_peers(devices)
    ctl = [torch.zeros(2, dtype=torch.int64, device=d) for d in devices]
    flags = [torch.zeros(n, dtype=torch.int64, device=d) for d in devices]
    slots = [torch.zeros(n, dtype=torch.float64, device=d) for d in devices]
    parts = [torch.full((), i + 1.0, dtype=torch.float64, device=d)
             for i, d in enumerate(devices)]
    outs = [torch.empty((), dtype=torch.float64, device=d) for d in devices]
    graphs, streams = [], []
    for i, d in enumerate(devices):
        links = mesh_sync.partial_links([(slots[j][i], flags[j][i]) for j in range(n)], d)
        mesh_sync.preload(d)
        streams.append(graph_kernels.body_stream(d, ("sync round trip", i)))
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.device(d), torch.cuda.graph(graphs[-1], stream=streams[-1]):
            for _ in range(reps):
                mesh_sync.publish_partial(ctl[i], parts[i], links)
                mesh_sync.wait(ctl[i], flags[i], (1 << n) - 1, 16 * (i + 1) + 2, 10 ** 10,
                               slots=slots[i], out=outs[i])

    def replay():
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
        for d in set(devices):
            torch.cuda.synchronize(d)

    replay()
    t0 = time.perf_counter()
    replay()
    us = (time.perf_counter() - t0) * 1e6 / reps
    if any(int(c[1]) for c in ctl) or any(float(o) != n * (n + 1) / 2 for o in outs):
        raise RuntimeError(f"the sync points on {devices} failed: errors "
                           f"{[int(c[1]) for c in ctl]}, sums {[float(o) for o in outs]}")
    return us


def _profile(op):
    """One per-card solve of ``op`` under torch.profiler: {card: {"sync": ms, "other":
    ms}}, the device time of its kernels on each card, the sync kernels' (whose waits spin
    until the other cards publish) apart from the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import profiling

    scopes = {getattr(profiling, n) for n in dir(profiling) if n.startswith("PHASE_")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        op.solve(**LOOPS["per card"])
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.key in scopes:
            continue
        card = out.setdefault(f"cuda:{e.device_index}", {"sync": 0.0, "other": 0.0})
        sync = "wait_kernel" in e.key or "publish_" in e.key
        card["sync" if sync else "other"] += e.self_device_time_total / 1e3
    if not out:
        raise RuntimeError("the profiler saw no device time")
    return out


def _digests(fields):
    """The sha256 of each field's bytes, in order."""
    import hashlib

    return [hashlib.sha256(f.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for f in fields]


def _block_fields(x, shape):
    """The shards' fields of a whole (g, g) field: N row bands, or the (R, C) blocks
    row-major."""
    nr, nc = (shape, 1) if isinstance(shape, int) else shape
    h, w = x.shape[0] // nr, x.shape[1] // nc
    return [x[i * h:(i + 1) * h, j * w:(j + 1) * w] for i in range(nr) for j in range(nc)]


def _rank_case(device, grid, shards, mode, dtype_name, runs, platform):
    """One rank case on this rank (spawned by ``dist.launch_local``), in each leg of
    ``RANK_LEGS`` that can run here (the graph leg only over NCCL): rank 0
    returns {leg: {"ran": the transport every rank reported,
    "iterations", "digests": every shard's sha256 in shard order, "ms": each timed solve's
    slowest rank, "counts": every rank's ``cg.COUNTS`` a timed solve}}."""
    w, dtype = dist.world_size(), resolve_dtype(dtype_name)
    n = shards if isinstance(shards, int) else math.prod(shards)
    blocks = None if isinstance(shards, int) else tuple(shards)
    out = {}
    for label, (transport, graph) in RANK_LEGS.items():
        if n == w:  # one band or block a rank
            op = cg_sharded.make_sharded_operator(grid, mode=mode, dtype=dtype, device=device,
                                                  mesh_shape=blocks, transport=transport)
            ran = op.halo.transport

            def solve():
                x, s = cg_sharded.cg_solve_sharded(grid, operator=op, graph=graph)
                return [x], s
        else:
            mesh = dist.make_rank_mesh(blocks or n, devices=platform)
            op = cg_sharded.make_mesh_operator(grid, mesh, mode=mode, dtype=dtype,
                                               transport=transport)
            ran = op.link.transport

            def solve():
                return op.solve(graph=graph)

        if graph is None and not (op.halo.group is not None if n == w else op.rank_graph):
            del op  # no graph here: gloo between the ranks
            cg_sharded.clear_caches()
            continue
        xs, s = solve()
        digests = _digests(xs)
        del xs
        times = []
        cg.reset_counts()
        for _ in range(runs):
            dist.barrier()
            t0 = time.perf_counter()
            solve()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        counts = {k: v / runs for k, v in cg.COUNTS.items()}
        every = dist._all_objects({"ran": ran, "digests": digests, "ms": times,
                                   "counts": counts})
        out[label] = {"ran": [e["ran"] for e in every], "iterations": s.iterations,
                      "digests": [d for e in every for d in e["digests"]],
                      "ms": [max(e["ms"][i] for e in every) for i in range(runs)],
                      "counts": [e["counts"] for e in every]}
        del op
        cg_sharded.clear_caches()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out if dist.rank() == 0 else None


def _rank_cases(args, smi) -> int:
    """``--ranks W``: every rank case of W ranks against the one-process mesh of the same
    shards over the cards (its per-card and eager loops).  0 when every x is the same bit
    for bit and every leg ran the transport it should, else 1."""
    cases = {k: v for k, v in RANK_CASES.items() if v[0] == args.ranks}
    if not cases:
        print(f"mesh_scaling: no rank case has {args.ranks} ranks "
              f"({sorted({v[0] for v in RANK_CASES.values()})})", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rows, ok = [], True
    for label, (w, shards, mode, dtype_name) in cases.items():
        n = shards if isinstance(shards, int) else math.prod(shards)
        if args.platform == "cuda" and cards < n:
            print(f"mesh_scaling: {label} needs {n} CUDA cards, {cards} visible",
                  file=sys.stderr)
            return 1
        ranks = dist.launch_local(_rank_case, w, args.grid, shards, mode, dtype_name,
                                  args.runs, args.platform, device=args.platform)
        shape = (shards,) if isinstance(shards, int) else tuple(shards)
        spread = dist.make_mesh(shape, ("x", "y")[:len(shape)],
                                devices=args.platform if args.platform == "cpu"
                                else [f"cuda:{i}" for i in range(n)])
        op = cg_sharded.make_mesh_operator(args.grid, spread, mode=mode,
                                           dtype=resolve_dtype(dtype_name))
        res = _solve(op, args.runs, ("per card", "eager"))
        _free(op, spread)
        want = "nccl" if args.platform == "cuda" else "gloo"
        legs = {name: (_digests(_block_fields(x, shards)), k, ms)
                for name, (x, k, ms, _c) in res.items()}
        legs.update({name: (r["digests"], r["iterations"], statistics.median(r["ms"]))
                     for name, r in ranks.items()})
        same = len({(tuple(d), k) for d, k, _ in legs.values()}) == 1
        ran = {name: r["ran"] for name, r in ranks.items()}
        # the graph leg wherever NCCL joins the ranks: one graph a rank, or a card
        graphed = want == "nccl"
        ran_ok = ran == {**({"graph": [want] * w} if graphed else {}), "nccl": [want] * w,
                         "gloo": ["gloo"] * w}
        # every rank the same reads and replays a solve; the graph's one read and one
        # replay a card of the rank (shard i on card i)
        counts = {name: r["counts"] for name, r in ranks.items()}
        alike = all(c == [c[0]] * w for c in counts.values())
        if graphed and "graph" in counts:
            alike &= counts["graph"][0] == {"host_reads": 1.0, "replays": float(n // w)}
        ok &= same and ran_ok and alike
        med = {name: ms for name, (_d, _k, ms) in legs.items()}
        graph = (f"from one graph {'a rank' if n == w else 'a card'} median "
                 f"{med['graph']!r} ms "
                 f"({counts['graph'][0]} a solve), graph / per card "
                 f"{med['graph'] / med['per card']!r}, eager nccl / graph "
                 f"{med['nccl'] / med['graph']!r}; " if "graph" in med else
                 "no graph (gloo between the ranks); ")
        print(f"[mesh scaling] {args.grid}² {label}, {w} ranks over {n} cards: ranks over "
              f"{ran['nccl'][0]}: {graph}eager median {med['nccl']!r} ms "
              f"({counts['nccl'][0]} a solve); over gloo {med['gloo']!r} ms; one process's "
              f"mesh over the cards: per-card graphs {med['per card']!r} ms, eager "
              f"{med['eager']!r} ms; eager nccl / per card {med['nccl'] / med['per card']!r}, "
              f"gloo / eager nccl {med['gloo'] / med['nccl']!r}; iterations "
              f"{sorted({k for _d, k, _m in legs.values()})}; x bit for bit in all "
              f"{len(legs)} legs (each shard's sha256): {same}; every rank's reads and "
              f"replays alike: {alike}; transports {ran} [{smi}]", flush=True)
        rows.append({"grid": args.grid, "case": label, "ranks": w, "shards": list(shape),
                     "mode": mode, "dtype": dtype_name, "median_ms": med, "transports": ran,
                     "counts": counts,
                     "iterations": {name: k for name, (_d, k, _m) in legs.items()},
                     "x_equal": same, "card": smi})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


def _free(op, mesh):
    del op
    cg_sharded.clear_caches()
    for d in {d for d in mesh.devices if d.type == "cuda"}:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.mesh_scaling",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", type=int, default=20480)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--json", default=None)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--profile", action="store_true",
                   help="profile one per-card solve of each case (device time by card)")
    p.add_argument("--per-card", type=int, default=1,
                   help="shards a card: the row-band cases with this many times the shards")
    p.add_argument("--ranks", type=int, default=0,
                   help="the rank cases of this many ranks (NCCL and gloo between them)")
    args = p.parse_args(argv)
    if args.ranks:
        return _rank_cases(args, sysinfo.nvidia_smi() if args.platform == "cuda" else "cpu")
    k = args.per_card
    cases = CASES if k == 1 else tuple(((n * k,), m, d) for (n, *rest), m, d in CASES
                                       if not rest)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(math.prod(shape) for shape, _m, _d in cases) // k
    if args.platform == "cuda" and cards < need:
        print(f"mesh_scaling: needs {need} CUDA cards, {cards} visible (or --platform=cpu)",
              file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi() if args.platform == "cuda" else "cpu"
    if args.profile and args.platform == "cuda":
        from torch.profiler import ProfilerActivity, profile

        # CUPTI sees a graph's kernels only if it ran before the graph was captured
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    one = "cuda:0" if args.platform == "cuda" else "cpu"
    rows, ok, sync = [], True, {}
    for shape, mode, dtype_name in cases:
        axes = ("x", "y")[:len(shape)]
        spread = dist.make_mesh(shape, axes, devices=args.platform if args.platform == "cpu"
                                else [f"cuda:{i}" for i in range(math.prod(shape) // k)])
        shared = dist.make_mesh(shape, axes, devices=[one])
        dtype = resolve_dtype(dtype_name)
        op = cg_sharded.make_mesh_operator(args.grid, spread, mode=mode, dtype=dtype)
        res = _solve(op, args.runs, ("per card", "eager"))
        prof = _profile(op) if args.profile and args.platform == "cuda" else None
        _free(op, spread)
        op = cg_sharded.make_mesh_operator(args.grid, shared, mode=mode, dtype=dtype)
        res.update(_solve(op, args.runs, ("one card",)))
        _free(op, shared)
        (xc, kc, mc, cc), (xe, ke, me, ce), (xo, ko, mo, co) = (res[n] for n in LOOPS)
        same = kc == ke == ko and torch.equal(xc, xe) and torch.equal(xc, xo)
        ok &= same
        split = "x".join(map(str, shape))
        sync_us = None
        if args.platform == "cuda":  # a dot sync point across the cards
            used = tuple(dict.fromkeys(spread.devices))
            if used not in sync:
                sync[used] = _sync_us(used)
            sync_us = sync[used]
            print(f"[mesh scaling] a dot sync point across {len(used)} cards: "
                  f"{sync_us!r} µs (a graph of {SYNC_REPS} a card) [{smi}]", flush=True)
        if prof is not None:
            print(f"[mesh scaling] {split} {mode} {dtype_name}, one per-card solve profiled, "
                  "device ms by card: " + ", ".join(
                      f"{card} sync {v['sync']!r} other {v['other']!r}"
                      for card, v in sorted(prof.items())) + f" [{smi}]", flush=True)
        print(f"[mesh scaling] {args.grid}² {split} {mode} {dtype_name} on "
              f"{[str(d) for d in spread.devices]}: per-card graphs {kc} iterations, median "
              f"{mc!r} ms ({cc} a solve); eager {ke} iterations, median {me!r} ms ({ce} a "
              f"solve); every shard on {one}: {ko} iterations, median {mo!r} ms "
              f"({co} a solve); eager / per card {me / mc!r}, one card / per card "
              f"{mo / mc!r}; x bit for bit in all three: {same} [{smi}]", flush=True)
        rows.append({"grid": args.grid, "mesh": list(shape), "mode": mode,
                     "dtype": dtype_name, "devices": [str(d) for d in spread.devices],
                     "loops": list(LOOPS), "iterations": [kc, ke, ko],
                     "median_ms": [mc, me, mo], "counts": [cc, ce, co], "x_equal": same,
                     "sync_us": sync_us, "profile": prof, "card": smi})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

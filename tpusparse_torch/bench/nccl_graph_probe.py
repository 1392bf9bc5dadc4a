"""Whether NCCL's calls run from the body of a CUDA graph's WHILE node, as a rank's sharded
CG loop captures them (``solvers.cg_sharded.MeshLoop`` on NCCL ranks).

    python -m tpusparse_torch.bench.nccl_graph_probe [--ranks 1,2] [--rows 20480]
        [--iters 14]

For each W of ``--ranks`` a group of W processes (``dist.launch_local``, rank r on card r;
W = 1 is a group of one rank, its NCCL calls to itself) runs the probe loop twice from
the same start: eagerly, and from a graph that ``cg.DeviceLoop`` captures as a rank's
``MeshLoop`` does (a WHILE node, two iterations a body, each under an IF node, the
condition set on the card).  An
iteration makes the rank loop's NCCL calls on one rank's state: ``cg_sharded._allsum``
of a 0-d partial (an all-gather of every rank's, added in rank order on the card), and a
``batch_isend_irecv`` of a ``--rows``-long row to the next rank and from the previous one
(to and from itself when W = 1); then plain ops fold what arrived into the state, so that
every iteration's values depend on the last.  Printed, one JSON line a group: whether the
capture ran, its error if not, the iterations, whether the row and the partial are the
eager loop's bit for bit on every rank, and the eager and graph ms an iteration (rank 0's
host clock around a synchronised solve).  Exits 1 unless every group captured and agreed.

``NCCL_GRAPH_MIXING_SUPPORT`` in the environment overrides the port's 0
(``dist.nccl_group``; with 1 the capture fails).  Needs W cards for W ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist
from ..kernels import graph as graph_kernels
from ..solvers import cg, cg_sharded


class ProbeLoop(cg.DeviceLoop):
    """The probe's loop on one rank: ``cg.DeviceLoop``'s graph (or its eager loop) around
    an iteration of the rank loop's NCCL calls.  Its state: a row (sent to the next
    rank), the row received (from the previous one) and a 0-d partial."""

    def __init__(self, group, device, rows, iters, graphed, dtype=torch.float64):
        self._init_loop("classic", dtype, device, iters, 0.0, cg.UNROLL)
        self.graphed, self.shape, self.group = graphed, (1,), group
        self.capture_mode, self.guard_first = "thread_local", True  # as a rank's MeshLoop
        w, r = dist.world_size(), dist.rank()
        self.next, self.prev = (r + 1) % w, (r - 1) % w
        rng = np.random.default_rng(1000 + r)
        self.row0 = torch.from_numpy(rng.standard_normal(rows)).to(device=device, dtype=dtype)
        self.row, self.halo = torch.empty_like(self.row0), torch.empty_like(self.row0)
        self.part = torch.empty((), dtype=dtype, device=device)

    def solve(self):
        return self._run(self._start)

    def _start(self, x):
        del x
        self.row.copy_(self.row0)
        self.halo.zero_()
        self.part.fill_(dist.rank() + 1.0)
        self.rr.fill_(1.0)
        self.tol2.zero_()  # the loop runs max_iters iterations
        self.k.zero_()

    def _iteration(self, x, parity):
        del x, parity
        total = cg_sharded._allsum(self.part, group=self.group)
        ops = [tdist.P2POp(tdist.isend, self.row, self.next, self.group),
               tdist.P2POp(tdist.irecv, self.halo, self.prev, self.group)]
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
        self.row.mul_(0.5).add_(self.halo)
        self.part.mul_(0.25).add_(total).add_(self.halo[0])
        self.k.add_(1)


def _solve_ms(loop, runs=3):
    """(the loop's row and partial on the host, k, ms an iteration: the median of
    ``runs`` synchronised solves after the first)."""
    loop.solve()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = loop.solve()[1]  # x dropped: the next solve replays the same graph
        times.append((time.perf_counter() - t0) * 1e3 / max(k, 1))
    return loop.row.cpu(), loop.part.item(), k, sorted(times)[len(times) // 2]


def rank_probe(device, rows, iters):
    """One rank's probe: eager, then graph; rank 0 returns the group's report."""
    group = dist.nccl_group(device)
    out = {"ranks": dist.world_size(), "rows": rows,
           "mixing": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT")}
    row_e, part_e, k_e, ms_e = _solve_ms(ProbeLoop(group, device, rows, iters, False))
    graph_kernels.reset_launches()
    cg.reset_launches()
    try:
        row_g, part_g, k_g, ms_g = _solve_ms(ProbeLoop(group, device, rows, iters, True))
        same = bool(torch.equal(row_e, row_g)) and part_e == part_g and k_e == k_g
        mine = {"captured": True, "same": same, "k": k_g}
        # the graph leg's launches of the condition kernel: the captures' (set apart) and
        # the replays' (``cg.LAUNCHES``)
        out.update(eager_ms=ms_e, graph_ms=ms_g, replayed=dict(cg.LAUNCHES))
    except Exception as e:  # noqa: BLE001 - the probe reports what refused the capture
        mine = {"captured": False, "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    every = dist._all_objects(mine)
    out.update(k_eager=k_e, every_rank=every,
               ok=all(m["captured"] and m["same"] for m in every))
    return out if dist.rank() == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", default="1,2")
    ap.add_argument("--rows", type=int, default=20480)
    ap.add_argument("--iters", type=int, default=14)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nccl_graph_probe: needs a card", file=sys.stderr)
        return 1
    ok = True
    for w in (int(v) for v in args.ranks.split(",")):
        if w > torch.cuda.device_count():
            print(f"nccl_graph_probe: {w} ranks need {w} cards", file=sys.stderr)
            return 1
        report = dist.launch_local(rank_probe, w, args.rows, args.iters, device="cuda")
        print(json.dumps(report), flush=True)
        ok = ok and report["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Sharded generic-vs-structured CG comparison: the port's counterpart of
``scripts/sharded_compare.py`` (the reference's in-solver comparison workflow: its generic
``csr_spmv_kernel`` lives inside the partitioned solver,
cg_solver_mgpu_partitioned.cu:40-56).

Runs the sharded CG (``cli.cg_solver_multichip``) with the generic band-local ELL kernel
(``mode=csr``) and with the structured stencil modes on the same ranks and grid, each with
the host-stepped loop's timers (``--timers``), writes one export per mode and prints a
markdown table of the buckets.

    python -m tpusparse_torch.scripts.sharded_compare [--grid 1024] [--devices 8]
        [--runs 5] [--warmup 2] [--outdir results/json] [--modes csr,stencil5,stencil5-const]
        [--dtype=f32|f64|bf16] [--transport=mesh|gloo] [--platform=cuda|cpu]

``--devices N`` is the number of shards: by default an N-shard mesh that the multichip
CLI drives in this process, as the JAX script's mesh; ``--transport=gloo`` spawns N gloo
ranks running the CLI instead (``dist.launch_local``), their halos and dots staged
through the host.  On one card the shards share it, and their kernels take turns on it,
so the table is the machinery's cost, not a scaling figure; ``--platform=cpu`` runs them
on the CPU (the JAX script's ``--cpu-mesh``).  The table names the transport.  The JAX
table's † column (buckets clipped by its dispatch-floor correction) has no counterpart:
the correction is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.sharded_compare",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--outdir", default="results/json")
    ap.add_argument("--modes", default="csr,stencil5,stencil5-const")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                    help="the state dtype of every run")
    ap.add_argument("--transport", default="mesh", choices=["mesh", "gloo"],
                    help="a mesh in this process, or gloo ranks")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="where the shards run: the card, or the CPU")
    args = ap.parse_args(argv)

    from .. import dist
    from .._device import resolve_device
    from ..cli import cg_solver_multichip

    resolve_device(args.platform)  # raises without a card, before any spawn
    os.makedirs(args.outdir, exist_ok=True)
    rc = 0
    outs = []
    for mode in args.modes.split(","):
        out = os.path.join(args.outdir,
                           f"cg_sharded_compare_{args.grid}_{mode}_{args.devices}dev.json")
        argv = [f"gen:{args.grid}", f"--chips={args.devices}", f"--mode={mode}", "--timers",
                f"--runs={args.runs}", f"--warmup={args.warmup}", f"--dtype={args.dtype}",
                f"--platform={args.platform}", f"--json={out}"]
        rc |= (cg_solver_multichip.main(argv) if args.transport == "mesh"
               else dist.launch_local(cg_solver_multichip.rank_main, args.devices, argv,
                                      device=args.platform))
        outs.append((mode, out))

    who = "shards (mesh)" if args.transport == "mesh" else "ranks (gloo)"
    print(f"\n| sharded CG @ {args.grid}² on {args.devices} {who} | total (median) | SpMV | "
          "halo | allreduce | BLAS1 | iters |")
    print("|---|---|---|---|---|---|---|")
    device = None
    for mode, path in outs:
        with open(path) as f:
            r = json.load(f)
        t, c = r["timing"], r["convergence"]
        device = r["device"].get("nvidia_smi") or r["device"]["device_kind"]
        label = mode + (" (generic ELL kernel)" if mode == "csr" else "")
        print(f"| {label} | {t['total_median_ms']:.1f} ms | {t.get('spmv_ms', 0.0):.1f} ms | "
              f"{t.get('halo_ms', 0.0):.1f} ms | {t.get('allreduce_ms', 0.0):.1f} ms | "
              f"{t.get('blas1_ms', 0.0):.1f} ms | {c['iterations']} |")
    print(f"\n[{device}; {who} sharing a card take turns on it]")
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Scaling sweeps: the port's counterpart of ``scripts/sweep.py`` (the reference's
scripts/benchmarking/*.sh as one parameterized script).

    python -m tpusparse_torch.scripts.sweep strong [--sizes 2048,4096] [--chips 1,2,4,8]
    python -m tpusparse_torch.scripts.sweep weak   [--configs 1:1024,2:1448,4:2048,8:2896]
    python -m tpusparse_torch.scripts.sweep spmv   [--sizes 1024,2048,4096] [--modes stencil5,csr]
        [--runs N] [--outdir results/json] [--dtype=f32|f64|bf16] [--platform=cuda|cpu]

The JAX script's defaults (the reference's benchmark_problem_sizes.sh:17-22 strong and
benchmark_weak_scaling.sh:17-22 weak, cut to size), the CPU's smaller ones under
``--platform=cpu``.  The rank counts are capped at the cards there are (one on the CPU):
one H100 runs the one-rank points only.  ``tpusparse_torch.clear_caches()`` runs between
points.  Results land in ``<outdir>/sweep_*.json`` and ``sweep_*.csv``; run
``python -m tpusparse_torch.scripts.plot_results`` afterwards.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.sweep", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kind", choices=["strong", "weak", "spmv"])
    ap.add_argument("--sizes", default=None)
    ap.add_argument("--chips", default=None)
    ap.add_argument("--configs", default=None)
    ap.add_argument("--modes", default="stencil5,csr")
    ap.add_argument("--runs", type=int, default=0)
    ap.add_argument("--outdir", default="results/json")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                    help="the state dtype of every run")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the card's kernels, or their plain twins on the CPU")
    args = ap.parse_args(argv)

    import torch

    from .. import clear_caches
    from .._device import resolve_device
    from ..cli import cg_solver_multichip, spmv_bench

    on_cpu = resolve_device(args.platform).type == "cpu"
    ndev = 1 if on_cpu else torch.cuda.device_count()
    runs = args.runs or (3 if on_cpu else 10)
    common = [f"--dtype={args.dtype}", f"--platform={args.platform}"]
    os.makedirs(args.outdir, exist_ok=True)

    def parse_ints(s, default):
        return [int(v) for v in (s or default).split(",")]

    rc = 0
    if args.kind == "spmv":
        sizes = parse_ints(args.sizes, "1024,2048,4096" if not on_cpu else "64,128")
        for g in sizes:
            rc |= spmv_bench.main(
                [f"gen:{g}", f"--mode={args.modes}", f"--runs={runs}", "--warmup=2",
                 f"--json={args.outdir}/sweep_spmv_{g}.json",
                 f"--csv={args.outdir}/sweep_spmv.csv", *common])
            clear_caches()
    elif args.kind == "strong":
        sizes = parse_ints(args.sizes, "2048,4096" if not on_cpu else "64")
        chips = [n for n in parse_ints(args.chips, "1,2,4,8") if n <= ndev]
        for g in sizes:
            for n in chips:
                if g % n:
                    continue
                rc |= cg_solver_multichip.main(
                    [f"gen:{g}", f"--chips={n}", f"--runs={runs}", "--warmup=1",
                     f"--json={args.outdir}/sweep_strong_{g}_{n}chip.json",
                     f"--csv={args.outdir}/sweep_strong.csv", *common])
                clear_caches()
    else:  # weak
        default = "1:1024,2:1448,4:2048,8:2896" if not on_cpu else "1:32,2:48,4:64,8:96"
        pairs = [(int(a), int(b)) for a, b in
                 (c.split(":") for c in (args.configs or default).split(","))]
        for n, g in pairs:
            if n > ndev:
                continue
            # round down to a multiple of n (never below n): tidy sweep sizes
            g = max(g - g % n, n)
            rc |= cg_solver_multichip.main(
                [f"gen:{g}", f"--chips={n}", f"--runs={runs}", "--warmup=1",
                 f"--json={args.outdir}/sweep_weak_{n}chip_{g}.json",
                 f"--csv={args.outdir}/sweep_weak.csv", *common])
            clear_caches()
    return rc


if __name__ == "__main__":
    sys.exit(main())

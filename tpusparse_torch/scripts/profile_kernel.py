"""Kernel profiling wrapper: the port's counterpart of ``scripts/profile_kernel.py`` (the
reference's scripts/profiling/profile_kernel.sh, ``ncu --set full`` per mode, :51-57).
Captures a ``torch.profiler`` trace of SpMV applies per mode.

    python -m tpusparse_torch.scripts.profile_kernel gen:4096 \\
        --mode=stencil5,stencil5-const [--outdir=results/traces] [--reps=5] \\
        [--platform=cuda|cpu]

Every mode is checked before the operand is loaded (rc 2 for an unknown one, as
``spmv_bench``).  Per mode: one warm-up apply (the kernels' build and first launch stay
outside the capture), then ``--reps`` chained applies (each output the next input) under
``bench.profiling.profiled_run``, which writes a Chrome trace JSON
(``<host>_<pid>.<ms>.pt.trace.json``) into ``<outdir>/<name>_<mode>``.  Open it in
chrome://tracing or https://ui.perfetto.dev, or point TensorBoard's PyTorch profiler plugin
at the directory.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.profile_kernel",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("matrix", help="gen:<g> or .mtx path")
    ap.add_argument("--mode", default="stencil5")
    ap.add_argument("--outdir", default="results/traces")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the card's kernels, or their plain twins on the CPU")
    args = ap.parse_args(argv)

    from .. import ops
    from .._device import resolve_device
    from ..bench import profiling
    from ..cli.spmv_bench import load_operand

    # every mode before any (expensive) load or trace: spmv_bench's contract
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    for m in modes:
        if m not in ops.available_modes():
            print(f"[ERROR] unknown mode '{m}'. Available: {ops.available_modes()}",
                  file=sys.stderr)
            return 2
    device = resolve_device(args.platform)
    mat, name = load_operand(args.matrix)
    for mode in modes:
        op = ops.get_operator(mode, mat, device=device)
        x = op.ones_b()
        op.run_device(x)  # the build and first launch, outside the capture
        logdir = os.path.join(args.outdir, f"{name}_{mode}")

        def reps():
            y = x
            for _ in range(args.reps):
                y = op.run_device(y)
            return y

        profiling.profiled_run(reps, logdir=logdir)
        op.free()
        print(f"[OK] {mode}: trace in {logdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

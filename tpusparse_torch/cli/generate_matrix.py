"""Stencil matrix generator CLI of the port.

Counterpart of ``tpusparse/cli/generate_matrix.py`` (reference
src/matrix/generate_matrix.cu:35-44):

    python -m tpusparse_torch.cli.generate_matrix <grid_dim> <output.mtx> [--diag D]
        [--offdiag O]

Writes the g×g 5-point stencil as a Matrix Market file on the host (the native writer
when its library builds, else the Python one); the CLIs of the port read it back.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import generate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.generate_matrix", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("grid_dim", type=int)
    p.add_argument("output")
    p.add_argument("--diag", type=float, default=generate.DEFAULT_DIAG)
    p.add_argument("--offdiag", type=float, default=generate.DEFAULT_OFFDIAG)
    args = p.parse_args(argv)
    if args.grid_dim < 1:
        print("[ERROR] grid_dim must be >= 1", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    nnz = generate.write_matrix_market_stencil5(args.output, args.grid_dim, args.diag,
                                                args.offdiag)
    n = args.grid_dim * args.grid_dim
    print(f"[OK] wrote {args.output}: {n}x{n}, nnz={nnz} ({time.perf_counter() - t0:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

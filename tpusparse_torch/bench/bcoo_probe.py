"""Where does one ``torch.sparse_csr_tensor`` matvec (cuSPARSE) go wrong?

    python -m tpusparse_torch.bench.bcoo_probe [--grids 10240,14654,...] [--json PATH]

On one CUDA card: for each grid g, the constant 5-point stencil's CSR is made on the card
(``generate.make_stencil5_csr_device``) and handed whole, as one sparse CSR tensor with
int32 or int64 indices, to ``a @ x`` for a seeded random x; its y is held against the ELL
kernel's (``kernels.ell.spmv_ell``, the kernel that replaces K12/K13) as max |Δy| / max
|y|, and the matvec is timed with CUDA events (best of 3 windows of 5).  The default
grids give 5.2e8 (10240²), 1.07e9 (≈ 2^30), 1.34e9, 1.62e9, 1.90e9 and 2.10e9 (20480²)
stored entries.  Each line prints with the card's name and power limit; ``--json`` keeps
the rows.  This is what sets ``ops.BCOO_BAND_ENTRIES``.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

import torch

from .. import generate
from ..kernels import ell
from . import sysinfo

GRIDS = (10240, 14654, 16384, 18000, 19494, 20480)


def probe(g, dtype, idx, reps=3, chain=5):
    """{"g", "nnz", "dtype", "index", "rel_err", "ms"} of one whole-matrix matvec."""
    dev = torch.device("cuda")
    x = torch.rand(g * g, generator=torch.Generator(device=dev).manual_seed(g), device=dev,
                   dtype=dtype)
    vals, cols = generate.make_stencil5_ell_device(g, dtype=dtype, device=dev)
    y_ell = ell.spmv_ell(vals, cols, x)
    del vals, cols
    torch.cuda.empty_cache()
    row_ptr, col, val = generate.make_stencil5_csr_device(g, dtype=dtype, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(row_ptr.to(idx), col.to(idx), val, size=(g * g, g * g),
                                    check_invariants=False)
    del row_ptr, col
    y = a @ x
    err = float((y.double() - y_ell.double()).abs().max() / y_ell.double().abs().max())
    del y
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            a @ x
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / chain)
    del a, val, x, y_ell
    torch.cuda.empty_cache()
    return {"g": g, "nnz": generate.stencil5_nnz(g), "dtype": str(dtype).removeprefix("torch."),
            "index": str(idx).removeprefix("torch."), "rel_err": err, "ms": best}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.bcoo_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grids", default=",".join(map(str, GRIDS)))
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bcoo_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi()
    rows = []
    for g in (int(s) for s in args.grids.split(",")):
        for dtype in (torch.float32, torch.float64):
            for idx in (torch.int32, torch.int64):
                try:
                    r = probe(g, dtype, idx)
                except RuntimeError as e:  # a refused matvec is a finding too
                    r = {"g": g, "nnz": generate.stencil5_nnz(g), "dtype": str(dtype),
                         "index": str(idx), "rel_err": float("nan"), "ms": None,
                         "error": str(e).splitlines()[0]}
                    torch.cuda.empty_cache()
                rows.append(r)
                verdict = ("right" if r["rel_err"] <= 1e-5 else
                           f"ERROR {r['error']}" if "error" in r else "WRONG")
                print(f"[bcoo probe] g={g} nnz={r['nnz']} {r['dtype']} {r['index']}: rel err "
                      f"{r['rel_err']:.3e} ({verdict}), {r['ms']!r} ms [{smi}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "torch": torch.__version__, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

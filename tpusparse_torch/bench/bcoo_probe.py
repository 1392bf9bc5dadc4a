"""Where does one ``torch.sparse_csr_tensor`` matvec (cuSPARSE) go wrong?

    python -m tpusparse_torch.bench.bcoo_probe [--grids 10240,14654,...]
        [--variants device,mv_out,host_carried] [--json PATH]

On one CUDA card: for each grid g, the constant 5-point stencil's CSR is handed whole, as
one sparse CSR tensor, to a matvec on a seeded random x; its y is held against the ELL
kernel's (``kernels.ell.spmv_ell``, the kernel that replaces K12/K13) as max |Δy| / max
|y|, and the matvec is timed with CUDA events (best of 3 windows of 5).  Variants:

  device        the CSR made on the card (``generate.make_stencil5_csr_device``), int32
                and int64 indices, ``a @ x``;
  mv_out        the same with int32 indices, ``torch.mv(a, x, out=y)`` as ``bcoo``'s bands
                call it;
  host_carried  the CSR as the host builds it (``formats.stencil5_to_csr``: int64
                indices, f64 values; here copied down from the card's, which equals it
                array for array) carried up by ``torch.tensor(..., device=...)`` with int32
                indices, then ``a @ x``: the operand ``bcoo`` had before it was cut into
                bands.  The carried arrays are first compared with the card's
                (``carried_equal``), so a fault of the carry shows apart from cuSPARSE's.

The default grids give 5.2e8 (10240²), 1.07e9 (≈ 2^30), 1.34e9, 1.62e9, 1.90e9 and 2.10e9
(20480²) stored entries.  ``host_carried`` holds the host CSR, ~40 GB at 20480² in f64.
Each line prints with the card's name and power limit; ``--json`` keeps the rows.  This
is what sets ``ops.BCOO_BAND_ENTRIES``.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

import numpy as np
import torch

from .. import generate
from ..kernels import ell
from . import sysinfo

GRIDS = (10240, 14654, 16384, 18000, 19494, 20480)
VARIANTS = ("device", "mv_out", "host_carried")


def _carried(row_ptr, col, val, idx):
    """The host CSR's arrays (int64 indices, f64 values) carried back up by torch.tensor,
    and whether each equals the card's own."""
    dev = val.device
    host = [row_ptr.cpu().numpy().astype(np.int64), col.cpu().numpy().astype(np.int64),
            val.cpu().numpy().astype(np.float64)]
    out = []
    for a in (0, 1):
        out.append(torch.tensor(host[a], dtype=idx, device=dev))
        host[a] = None
    out.append(torch.tensor(host[2], dtype=val.dtype, device=dev))
    del host
    equal = all(torch.equal(c, d.to(c.dtype)) for c, d in zip(out, (row_ptr, col, val)))
    return out, equal


def probe(g, dtype, idx, variant="device", reps=3, chain=5):
    """{"g", "nnz", "dtype", "index", "variant", "rel_err", "ms"} of one whole-matrix
    matvec (and ``carried_equal`` for ``host_carried``)."""
    dev = torch.device("cuda")
    x = torch.rand(g * g, generator=torch.Generator(device=dev).manual_seed(g), device=dev,
                   dtype=dtype)
    vals, cols = generate.make_stencil5_ell_device(g, dtype=dtype, device=dev)
    y_ell = ell.spmv_ell(vals, cols, x)
    del vals, cols
    torch.cuda.empty_cache()
    row_ptr, col, val = generate.make_stencil5_csr_device(g, dtype=dtype, device=dev)
    extra = {}
    if variant == "host_carried":
        (row_ptr, col, val), extra["carried_equal"] = _carried(row_ptr, col, val, idx)
        torch.cuda.empty_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(row_ptr.to(idx), col.to(idx), val, size=(g * g, g * g),
                                    check_invariants=False)
    del row_ptr, col
    y = torch.empty_like(x)

    def matvec():
        if variant == "mv_out":
            torch.mv(a, x, out=y)
            return y
        return a @ x

    err = float((matvec().double() - y_ell.double()).abs().max()
                / y_ell.double().abs().max())
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            matvec()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / chain)
    del a, val, x, y, y_ell
    torch.cuda.empty_cache()
    return {"g": g, "nnz": generate.stencil5_nnz(g), "dtype": str(dtype).removeprefix("torch."),
            "index": str(idx).removeprefix("torch."), "variant": variant, "rel_err": err,
            "ms": best, **extra}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.bcoo_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grids", default=",".join(map(str, GRIDS)))
    p.add_argument("--variants", default="device")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bcoo_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi()
    rows = []
    runs = [(variant, idx) for variant in args.variants.split(",")
            for idx in ((torch.int32, torch.int64) if variant == "device" else (torch.int32,))]
    for g in (int(s) for s in args.grids.split(",")):
        for dtype in (torch.float32, torch.float64):
            for variant, idx in runs:
                try:
                    r = probe(g, dtype, idx, variant)
                except RuntimeError as e:  # a refused matvec is a finding too
                    r = {"g": g, "nnz": generate.stencil5_nnz(g), "dtype": str(dtype),
                         "index": str(idx), "variant": variant, "rel_err": float("nan"),
                         "ms": None, "error": str(e).splitlines()[0]}
                    torch.cuda.empty_cache()
                rows.append(r)
                verdict = ("right" if r["rel_err"] <= 1e-5 else
                           f"ERROR {r['error']}" if "error" in r else "WRONG")
                carried = (f", carried arrays equal the card's: {r['carried_equal']}"
                           if "carried_equal" in r else "")
                print(f"[bcoo probe] g={g} nnz={r['nnz']} {r['dtype']} {r['index']} "
                      f"{variant}: rel err {r['rel_err']:.3e} ({verdict}){carried}, "
                      f"{r['ms']!r} ms [{smi}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "torch": torch.__version__, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

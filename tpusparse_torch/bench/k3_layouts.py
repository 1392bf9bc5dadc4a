"""Why K3 has the vector body it has: a timing of the designs it was chosen over.

    python -m tpusparse_torch.bench.k3_layouts [--grid 20480] [--json PATH]

On one CUDA card, on a g² band with halo rows (seeded random fields, f32, f64 and bf16),
it builds ``k3_layouts.cu`` with nvcc (into ``tpusparse_torch/build/layouts/``) and
times, with CUDA events in turns (each candidate's best of 3 windows of 20 launches):

- the package's K3 (``kernels.stencil5.spmv_stencil5_const``): its vector body and its
  scalar body (``_scalar_body=True``), each without and with its dot; and the vector
  body's entry point with blocks taking stacks of 1, 2, 4 and 8 tiles, without and with
  its dot (the package takes ``stencil5.VEC_STACK``: 1 without, 4 with);
- a shared-memory ring of x's rows fed by ``cp.async``, and one fed by a TMA bulk copy a
  row (``k3_layouts.cu``), each with blocks walking runs of 32, 64 and 128 rows;
- ``torch.Tensor.copy_`` of x into y: the same bytes moved, no stencil, the yardstick of
  what a read+write stream reaches on the card.

Each ring's y is held to the package's bit for bit first.  Every time prints beside the
call's bound (x read once and y written once over 3.35 TB/s), with the card's name and
power limit; ``--json`` keeps the times.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

from .. import _build
from ..kernels import stencil5 as st5
from . import sysinfo
from .blas1_layouts import in_turns

SOURCE = pathlib.Path(__file__).resolve().parent / "k3_layouts.cu"
RINGS = ("ring", "bulk")
RUNS = (32, 64, 128)
STACKS = (1, 2, 4, 8)
STATES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
HBM_BYTES_PER_S = 3.35e12
KW = {"diag": 5.0, "offdiag": -1.0}


def build():
    """The layouts' shared library, built once per source digest."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + (_build.CSRC / "reduce.cuh").read_bytes()).hexdigest()[:16]
    lib = _build.BUILD / "layouts" / digest / "libk3layouts.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        str(SOURCE)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    for ring in RINGS:
        for t in STATES:
            fn = getattr(so, f"tps_layout_k3_{ring}_{t}")
            fn.argtypes, fn.restype = [P, P, P, P, I, I, I, D, D, P], ctypes.c_int
    return so


def run(g, so, smi):
    out = {}
    for t, dtype in STATES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, hp, hn = (torch.rand(*s, generator=gen, device="cuda").to(dtype)
                     for s in ((g, g), (1, g), (1, g)))
        y = torch.empty_like(x)
        st = torch.cuda.current_stream().cuda_stream
        want = st5.spmv_stencil5_const(x, hp, hn, **KW)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        cands = {"K3 vector body": lambda: st5.spmv_stencil5_const(x, hp, hn, **KW),
                 "K3 scalar body": lambda: st5.spmv_stencil5_const(x, hp, hn, _scalar_body=True,
                                                                   **KW),
                 "K3 vector body with its dot": lambda: st5.spmv_stencil5_const(
                     x, hp, hn, with_dot=True, **KW),
                 "K3 scalar body with its dot": lambda: st5.spmv_stencil5_const(
                     x, hp, hn, with_dot=True, _scalar_body=True, **KW),
                 "torch copy_": lambda: y.copy_(x)}
        vec = getattr(_build.lib(), f"tps_spmv_stencil5_const_vec_{t}")
        part = torch.empty(st5._vec_partials(g, g, x.element_size(), 1), device="cuda",
                           dtype=torch.float64 if t == "f64" else torch.float32)
        res = torch.empty((), device="cuda", dtype=part.dtype)
        tickets = torch.zeros(1, device="cuda", dtype=torch.int32)
        for stack in STACKS:
            for dot in (False, True):
                args = (x.data_ptr(), hp.data_ptr(), hn.data_ptr(), y.data_ptr(), g, g, stack,
                        KW["diag"], KW["offdiag"], part.data_ptr() if dot else None,
                        tickets.data_ptr() if dot else None, res.data_ptr() if dot else None,
                        st)
                cands[f"vector body, stacks of {stack} tiles{' with its dot' if dot else ''}"] = (
                    lambda args=args: _build.check(vec(*args), "k3 vector body"))
        for ring in RINGS:
            fn = getattr(so, f"tps_layout_k3_{ring}_{t}")
            for rows in RUNS:
                args = (x.data_ptr(), hp.data_ptr(), hn.data_ptr(), y.data_ptr(), g, g, rows,
                        KW["diag"], KW["offdiag"], st)
                if fn(*args) != 0:
                    raise RuntimeError(f"k3 layout {ring} {t}: launch refused")
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise AssertionError(f"k3 layout {ring} {t} runs of {rows}: y differs "
                                         "from the package's K3")
                cands[f"{ring}, runs of {rows} rows"] = lambda fn=fn, args=args: fn(*args)
        for k, ms in in_turns(cands).items():
            out[f"{k} {t}"] = ms
            print(f"[k3 layouts] {t} {g}² {k}: {ms!r} ms ({100 * bound / ms:.1f}% of the "
                  f"bound {bound!r} ms) [{smi}]", flush=True)
        del x, hp, hn, y, want
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.bench.k3_layouts",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=20480)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_layouts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi()
    times = run(args.grid, build(), smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "grid": args.grid, "ms": times}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

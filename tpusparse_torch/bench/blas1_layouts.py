"""Why K5 and K6 take the launch layouts they do: a timing of the alternatives.

    python -m tpusparse_torch.bench.blas1_layouts [--grid 20480] [--json PATH]

On one CUDA card, at g² elements (f32 and f64, seeded random fields), it builds
``blas1_layouts.cu`` with nvcc (into ``tpusparse_torch/build/layouts/``) and times, with
CUDA events in turns (each candidate's best of 3 windows of 20 launches):

- p = r + β·p: the grid-stride loop over 16-byte vectors with 1, 2 or 4 vectors in flight
  on a fixed grid, and one vector per thread on a grid sized by the field, each in place
  and into a second buffer; the package's K5 (``kernels.blas1.p_update``); and
  ``torch.add(r, p, alpha=β)``, new output and ``out=p``;
- <a, b>: K6's loop with 2 or 4 vectors in flight, the package's K6 and ``torch.dot``.

Every candidate's p is held to the plain twin bit for bit, every dot to float64 to 1e-6.
Each line prints with the card's name and power limit; ``--json`` keeps the times.
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
from ..kernels import blas1
from . import sysinfo

SOURCE = pathlib.Path(__file__).resolve().parent / "blas1_layouts.cu"
PU = ("gs1", "gs2", "gs4", "os")
DOT = ("gs2", "gs4")


def build():
    """The layouts' shared library, built once per source digest."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + (_build.CSRC / "reduce.cuh").read_bytes()).hexdigest()[:16]
    lib = _build.BUILD / "layouts" / digest / "liblayouts.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        str(SOURCE)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int64
    for name in PU:
        for t in ("f32", "f64"):
            fn = getattr(so, f"tps_layout_pu_{name}_{t}")
            fn.argtypes, fn.restype = [P, P, P, P, I, P], ctypes.c_int
    for name in DOT:
        for t in ("f32", "f64"):
            fn = getattr(so, f"tps_layout_dot_{name}_{t}")
            fn.argtypes, fn.restype = [P, P, I, P, P, P, P], ctypes.c_int
    return so


def time_ms(fn, launches=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def in_turns(cands, turns=3):
    """{name: best ms}, the candidates timed in turns, forward then backward."""
    times = {k: [] for k in cands}
    for turn in range(turns):
        for k in (list(cands) if turn % 2 == 0 else list(reversed(cands))):
            times[k].append(time_ms(cands[k]))
    return {k: min(v) for k, v in times.items()}


def run(g, so, smi):
    n = g * g
    out = {}
    for dtype, t in ((torch.float32, "f32"), (torch.float64, "f64")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        r, p = (torch.rand(n, generator=gen, device="cuda", dtype=dtype) for _ in range(2))
        o = torch.empty_like(p)
        beta = torch.tensor(0.37, dtype=dtype, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        want = blas1.p_update_plain(beta, r, p.clone())
        cands = {"K5 (p_update)": lambda: blas1.p_update(beta, r, p),
                 "torch.add new output": lambda: torch.add(r, p, alpha=0.37),
                 "torch.add out=p": lambda: torch.add(r, p, alpha=0.37, out=p)}
        for name in PU:
            fn = getattr(so, f"tps_layout_pu_{name}_{t}")
            fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), o.data_ptr(), n, st)
            torch.cuda.synchronize()
            if not torch.equal(o, want):
                raise AssertionError(f"layout {name} {t}: p differs from the plain twin")
            for dst, label in ((p, "in place"), (o, "second buffer")):
                cands[f"{name} {label}"] = (
                    lambda fn=fn, dst=dst: fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(),
                                              dst.data_ptr(), n, st))
        for k, ms in in_turns(cands).items():
            out[f"p_update {k} {t}"] = ms
            print(f"[layouts] p_update {t} {k}: {ms!r} ms [{smi}]", flush=True)
        part = torch.empty(132 * 8, dtype=dtype, device="cuda")
        tickets = torch.zeros(1, dtype=torch.int32, device="cuda")
        res = torch.empty((), dtype=dtype, device="cuda")
        ref = float(torch.dot(r.double(), p.double()))
        cands = {"K6 (dot)": lambda: blas1.dot(r, p), "torch.dot": lambda: torch.dot(r, p)}
        for name in DOT:
            fn = getattr(so, f"tps_layout_dot_{name}_{t}")
            fn(r.data_ptr(), p.data_ptr(), n, part.data_ptr(), res.data_ptr(),
               tickets.data_ptr(), st)
            if abs(float(res) - ref) > 1e-6 * abs(ref):
                raise AssertionError(f"layout dot {name} {t}: {float(res)!r} against {ref!r}")
            cands[name] = (lambda fn=fn: fn(r.data_ptr(), p.data_ptr(), n, part.data_ptr(),
                                            res.data_ptr(), tickets.data_ptr(), st))
        for k, ms in in_turns(cands).items():
            out[f"dot {k} {t}"] = ms
            print(f"[layouts] dot {t} {k}: {ms!r} ms [{smi}]", flush=True)
        del r, p, o, want
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.bench.blas1_layouts",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=20480)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blas1_layouts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = sysinfo.nvidia_smi()
    times = run(args.grid, build(), smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "grid": args.grid, "ms": times}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpusparse_torch) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, nvcc and PyTorch built
for CUDA; it imports no JAX.  Phases, one line of output or more each:

  1. the card: nvidia-smi's name and power limit, torch's device properties;
  2. build the kernels of tpusparse_torch/csrc/ with nvcc (timed);
  3. each kernel against its plain PyTorch twin on the card, at g = 37, 1000 and 4096:
     K1-K3, K10 and K4-K7 in f32 and f64, K8 and K9 in their four planes/state pairs
     (f32/f32, f64/f64, bf16/f32, bf16/f64), stencils with and without halo rows (K9 and
     K10 for β = 0 with p = 0 and for β = 0.7, their fields bit for bit); K11 (DIA) and the ELL
     kernel of K12/K13 in f32 and f64 on the stencil's operands made on the card, and on
     host packs of five more matrices of about 10^6 rows: random banded with variable row
     lengths, uniformly random columns (ELL only: it has ~10^6 diagonals), a width-1
     diagonal, one with empty rows, and a DIA with offsets ±300 and ±1000 holding NaN
     where its diagonals leave the matrix (tolerances: f64 1e-12; f32 1e-5 for fields,
     1e-4 for dots, relative to the largest reference magnitude), and the ELL kernel's
     rectangular call (a quarter of the rows over their gather domain, y bit for bit, the
     sharded solver's csr band); K5 (p bit for bit) and
     K6 also on fields of 1, 3, 1369 and 10^6 elements, aligned and offset by one element
     in one operand or both, so that both bodies and the vector body's head and tail run,
     in f32, f64 and bf16; the bf16-state instances (K3, K4-K7, K8 with bf16 planes, K11,
     the ELL kernel square and rectangular) on the stencil's operands, fields bit for bit
     and their f32 dots to 1e-4.  K3 in both of its bodies, y bit for bit the twin's in
     every state: the vector body (the one the alignment rule picks at g = 1000 and 4096)
     and the forced scalar body there, the scalar body alone at g = 37, each launch taking
     the body the rule says (K3's two launch counts);
  4. the SpMVs on ones at 20480² against the analytic checksums: K3 and K10 in f32 and
     f64, K8 and K9 in f32, bf16c and f64, K11 and the ELL kernel in f32 and f64 (K9 and
     K10 with β = 0, p = 0 and r = ones); K3, K8, K11 and the ELL kernel at a bf16 state,
     summed in f64;
  5. the main paths, each read on its own: every launch count is set to 0 just before a
     path runs and read just after, and the path must have launched its own kernels (CG
     over stencil5-const recompute: K1, K2, K6; every classic CG: its SpMV, K4, K5, K6;
     the seeded-x0 solve also K7; a fused solve: K9 or K10, K4 and K6, and no K1, K2,
     K3, K5 or K8; an SpMV CLI run: its mode's kernel).  The CG CLI at
     gen:20480 with mode stencil5-const (f64 recompute, exactly 14 iterations; f32
     recompute; f32 classic, through K3 + K4 + K5 + K6), mode stencil5 (f64, exactly 14
     iterations; f32), stencil5-bf16c (f32), csr (f64, exactly 14 iterations; f32), dia
     (f64, exactly 14 iterations) and bcoo (cuSPARSE in row bands over the CSR made on
     the card; f64, exactly 14 iterations), the csr, dia and bcoo f64 solutions held to
     stencil5 f64's (Sum/Norm2 to 1e-10 relative); the SpMV CLI, one run per mode, over
     stencil5, stencil5-bf16c, stencil5-const, csr, dia and bcoo in f32 and bcoo in f64,
     each with the analytic checksums, and the csr-to-stencil5 kernel time ratio (the
     reference's 2.07×); the SpMV CLI over csr and the plain twins csr-xla and dia-xla at
     G_HOST² (each run's wall time, its operator's build included, is printed); the bf16c
     solution against the f32 stencil5 solution, bit for
     bit; one solve from a seeded nonzero x0 (K7), held with the x0 = 0 solve to the true
     residual, and one at a bf16 state (K7's bf16 instance), held to stencil5 f64's x
     within 1e-2; five fused p-update solves through cg.cg_solve(fused_pupdate=True), a
     median over a few solves after a warm-up each (stencil5 f64, exactly 14 iterations
     and the classic stencil5 f64 solution's Sum/Norm2 to 1e-10; stencil5 f32;
     stencil5-bf16c f32, bit for bit the fused stencil5 f32 solution; stencil5-const f64,
     exactly 14 iterations and the recompute solution's Sum/Norm2 to 1e-10;
     stencil5-const f32).  The bf16 state: the CG CLI at gen:20480 --dtype=bf16 in
     stencil5, stencil5-bf16c, stencil5-const --loop=classic, csr, dia and bcoo, each
     launching its bf16 kernels, converging, and giving Sum/Norm2 within 1e-2 of the
     stencil5 f64 solve's (its iterations and median printed beside the same mode's f32
     solve's); --loop=auto on stencil5-const at bf16 must return 2 (the recompute loop
     refuses a bf16 state); the SpMV CLI at --dtype=bf16 over the six modes at 20480²
     (--resident-x) and the plain twins stencil5-xla, stencil5-const-xla, csr-xla and
     dia-xla at G_HOST², each with the analytic checksums to 1e-12.  Every field on these
     paths is aligned for K3's vector body, so no path may launch K3's scalar body (the
     const classic solves in f32 and bf16 among them; phases 8-10 hold every run and rank
     to the same).  The kernels line's launches are the paths'
     counts summed; the counts of each path go to chiprun_out/chip_smoke_launches.json;
  6. each kernel against its plain twin at 20480² on seeded random fields at the main
     paths' shapes (same tolerances), then timed against it on those inputs (CUDA events,
     plain/kernel/kernel/plain), and against the one PyTorch call that computes the same
     function where there is one (kernel/library/library/kernel; held to it at 1e-5
     relative, a yardstick, not an oracle): torch.dot for K6, torch.add(r, p, alpha=β) for
     K5, F.conv2d with the 3×3 stencil for K3, bcoo's banded cuSPARSE matvec for the ELL
     kernel, and the ELL kernel's rectangular call at G_BIG²/4 rows (y bit for bit and
     its dot against the twin) beside the square call's GB/s.  The sharded paths' kernels
     at their shapes: on the bands of 2 and 4 ranks (G_BIG/2 and G_BIG/4 rows, G_BIG wide)
     and on the blocks of a 2 x 2 mesh (G_BIG/2 × G_BIG/2: a (G_BIG/2 − 2)-row core and
     one-row pieces G_BIG/2 wide) and of a 1 x 4 mesh (G_BIG × G_BIG/4) with halo rows,
     K8 (both planes dtypes) and K3 in the overlapped SpMV's three pieces into one y (y
     also bit for bit the whole band's call; K3 in both bodies, y bit for bit the twin's),
     K1 and K2 on the 4-rank band, in f32 and f64.  K3's vector body against its forced
     scalar body in turns (vector/scalar/scalar/vector) at 20480² and in the three pieces
     of every band and block shape, in f32, f64 and bf16, each beside the bound (and, in
     phase 8, the measured ceiling).  The bf16-state instances the same way (fields bit for bit): K3, K4-K7 and K8
     (bf16 planes) at 20480², against F.conv2d in bf16, torch.add and torch.dot on bf16
     (held to the kernel at 1e-2: the library rounds once where the kernel rounds each
     operation), K11 and the ELL kernel (against bcoo at bf16), the rectangular ELL call,
     and K3 and K8 in the band and block pieces.  Each kernel's bound: the bytes its call
     must move (inputs read once, outputs written once) over 3.35 TB/s, or its operations
     over the data sheet's peak rate, whichever is larger (a bf16 state computes in f32);
     the solves' median times, next to the card's name and power limit;
  7. one solve of each CG run of phase 5 (bcoo f64 included; of the bf16 runs, stencil5
     only), and of each fused solve, under torch.profiler, its device time split by kernel, and its idle time: phase 5's
     unprofiled median less the profiled device time (PERF.md section 5);
  8. the CG CLI's host-stepped loop and its other flags at gen:20480, each run from its own
     launch counts: --timers on stencil5 f64 (exactly 14 iterations, loop host-stepped,
     the spmv, blas1 and reduction buckets each > 0 and summing to no more than the
     median solve, Sum/Norm2 equal to phase 5's stencil5 f64 to 1e-10, launching K8, K4,
     K5 and K6; its buckets printed beside phase 7's split of the classic solve) and on
     stencil5-const f32 --loop=classic (K3, K4, K5, K6); --host (one timed run, 14
     iterations in f64) with --trace into chiprun_out/trace, whose Chrome trace must hold
     the phase names SpMV, BLAS_AXPY and BLAS_Update_P and the kernels of K8, K4 and K5
     (the ranges' wall time and their kernels' device time are printed); bare --device
     with no --mode in f64 (mode stencil5, 14 iterations); phase 5's medians beside those
     PERF.md records, and one phase scope's host time; the streaming probe kernels
     (kernels/stream_probe.py) against their twins on a 2^30 f32 field; the SpMV CLI with
     --ceiling-probe on stencil5, which must launch both probe kernels (every probe's
     GB/s, the achievable ceiling, the export's share of it and each kernel's share of it
     from phase 6's times) and python -m tpusparse_torch.bench.probes's two JSON files
     (the probe set again, and the copy chain's knee points with their passes and µs per
     pass); the phase's wall time.  Phase 7 leaves the phase scopes out of its sums;
  9. the multichip CLI (tpusparse_torch.cli.cg_solver_multichip) at gen:20480 in f64, its
     ranks gloo processes sharing the card (dist.launch_local, each rank running the CLI's
     main() in the group): stencil5 on 1, 2 and 4 ranks, stencil5-const recompute, csr
     and --timers stencil5 and stencil5-const on 4, each with --runs=3 --warmup=1,
     exactly 14 iterations and
     Sum/Norm2 equal to phase 5's solution of the same mode to 1e-10, the --timers buckets
     (halo, spmv, allreduce, blas1) each > 0 and summing to no more than the median; every
     rank's launch counts, set to 0 just before its CLI run, go to chiprun_out/sharded/
     and must hold its path's kernels (K8, K4, K5, K6; K1, K2, K6; the ELL kernel, K4, K5,
     K6; K3, K4, K5, K6); on every rank that has a neighbour, its halo exchanges
     (cg_sharded.HALO_CALLS) and, at least once each, launches of the path's halo kernels
     (K8; K1 and K2; the ELL kernel; K3) on the rows an exchange received, one rank none;
     each run's median and
     rank-time max/min/imbalance, the one-rank median beside phase 5's single-device one;
     stencil5 at --dtype=bf16 on 2 ranks (any iteration count, Sum/Norm2 within 1e-2 of
     phase 5's stencil5 f64); then stencil5-bf16c f32 on 2 ranks, its x equal to stencil5
     f32's bit for bit;
 10. the multichip CLI's 2-D block decomposition (--mesh2d) at gen:20480 f64, its ranks
     sharing the card, --runs=3 --warmup=1: stencil5 and stencil5-const on 2 x 2,
     --timers stencil5 on 2 x 2 and stencil5 on 1 x 4, each with exactly 14 iterations, and
     stencil5 --dtype=bf16 on 2 x 2 (the bars of phase 9's bf16 run),
     solver tpusparse-cg-sharded2d-RxC and Sum/Norm2 equal to phase 5's solution of the
     same mode to 1e-10, the --timers buckets each > 0 and summing to no more than the
     median; every rank must launch its SpMV (K8 or K3), K4, K5 and K6; a rank with a N/S
     neighbour must hand the exchanged rows to its SpMV's launches, one with a W/E
     neighbour must exchange columns and consume each in a side-column correction
     (cg_sharded.HALO_CALLS: column_exchange, column_correction), and one with neither
     exchange nothing; each median beside phase 9's 4-rank row-band median of its mode,
     and the rank-time max/min/imbalance.

Any failure raises and the exit code is non-zero.  The last lines are the kernels' JSON
record (launches summed over phases 5, 9 and 10) and then {"ok": true, "device": {...}}.
Exports go to chiprun_out/.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
G_BIG = 20480
G_HOST = 10240
GRIDS = (37, 1000, 4096)
DIAG, OFFDIAG = 5.0, -1.0
# wrapper name -> (short name, kernel functions in the CUDA source as a regex, source, the
# Pallas wrapper it replaces), in the order of the kernels line
KERNELS = {
    "spmv_stencil5_const_pupdate_dot": ("K1", "pupdate_dot_kernel",
                                        "tpusparse_torch/csrc/stencil5_const.cu",
                                        "tpusparse/kernels/stencil5.py:861"),
    "cg_const_update_recompute": ("K2", "update_recompute_kernel",
                                  "tpusparse_torch/csrc/stencil5_const.cu",
                                  "tpusparse/kernels/stencil5.py:1014"),
    "spmv_stencil5_const": ("K3", "spmv_(vec_)?kernel",
                            "tpusparse_torch/csrc/stencil5_const.cu",
                            "tpusparse/kernels/stencil5.py:718"),
    "cg_update": ("K4", "cg_update_kernel", "tpusparse_torch/csrc/blas1.cu",
                  "tpusparse/kernels/blas1.py:162"),
    "p_update": ("K5", "p_update_(vec_)?kernel", "tpusparse_torch/csrc/blas1.cu",
                 "tpusparse/kernels/blas1.py:199"),
    "dot": ("K6", "dot_(vec_)?kernel", "tpusparse_torch/csrc/blas1.cu",
            "tpusparse/kernels/blas1.py:80"),
    "axpby_dot": ("K7", "axpby_dot_kernel", "tpusparse_torch/csrc/blas1.cu",
                  "tpusparse/kernels/blas1.py:117"),
    "spmv_stencil5": ("K8", "spmv_planes_kernel", "tpusparse_torch/csrc/stencil5.cu",
                      "tpusparse/kernels/stencil5.py:432"),
    "spmv_stencil5_pupdate": ("K9", "pupdate_planes_kernel", "tpusparse_torch/csrc/stencil5.cu",
                              "tpusparse/kernels/stencil5.py:564"),
    "spmv_stencil5_const_pupdate": ("K10", "pupdate_spmv_kernel",
                                    "tpusparse_torch/csrc/stencil5_const.cu",
                                    "tpusparse/kernels/stencil5.py:1154"),
    "spmv_dia": ("K11", "spmv_dia_kernel", "tpusparse_torch/csrc/dia.cu",
                 "tpusparse/kernels/dia.py:84"),
    "spmv_ell": ("K12", "spmv_ell_kernel", "tpusparse_torch/csrc/ell.cu",
                 "tpusparse/kernels/gather_ell.py:283, tpusparse/kernels/gather_ell.py:645"),
}
# K3's scalar body's share of K3's launches (stencil5.LAUNCHES): every field of the main
# paths, the sharded runs and phase 6's shapes is aligned for the vector body, so none of
# them may launch the scalar body
K3_SCALAR = "spmv_stencil5_const_scalar"
# the kernels each main path must launch in its own run: the recompute loop's two passes
# and its <r0, r0>; the classic loop's SpMV with its dot, K4, K5 and <r0, r0>
RECOMPUTE = ("spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute", "dot")
CLASSIC = ("cg_update", "p_update", "dot")
# the CLI's CG runs of the main path: label -> (mode, arguments, iterations required,
# kernels required)
CG_RUNS = {
    "const f64 recompute": ("stencil5-const", ["--dtype=f64"], 14, RECOMPUTE),
    "const f32 recompute": ("stencil5-const", ["--dtype=f32"], None, RECOMPUTE),
    "const f32 classic": ("stencil5-const", ["--dtype=f32", "--loop=classic"], None,
                          ("spmv_stencil5_const",) + CLASSIC),
    "stencil5 f64": ("stencil5", ["--dtype=f64"], 14, ("spmv_stencil5",) + CLASSIC),
    "stencil5 f32": ("stencil5", ["--dtype=f32"], None, ("spmv_stencil5",) + CLASSIC),
    "bf16c f32": ("stencil5-bf16c", ["--dtype=f32"], None, ("spmv_stencil5",) + CLASSIC),
    "csr f64": ("csr", ["--dtype=f64"], 14, ("spmv_ell",) + CLASSIC),
    "csr f32": ("csr", ["--dtype=f32"], None, ("spmv_ell",) + CLASSIC),
    "dia f64": ("dia", ["--dtype=f64"], 14, ("spmv_dia",) + CLASSIC),
    "bcoo f64": ("bcoo", ["--dtype=f64"], 14, CLASSIC),
    # the bf16 state: the classic loop through the bf16 instances (bcoo: cuSPARSE in f32)
    "stencil5 bf16": ("stencil5", ["--dtype=bf16"], None, ("spmv_stencil5",) + CLASSIC),
    "bf16c bf16": ("stencil5-bf16c", ["--dtype=bf16"], None, ("spmv_stencil5",) + CLASSIC),
    "const bf16 classic": ("stencil5-const", ["--dtype=bf16", "--loop=classic"], None,
                           ("spmv_stencil5_const",) + CLASSIC),
    "csr bf16": ("csr", ["--dtype=bf16"], None, ("spmv_ell",) + CLASSIC),
    "dia bf16": ("dia", ["--dtype=bf16"], None, ("spmv_dia",) + CLASSIC),
    "bcoo bf16": ("bcoo", ["--dtype=bf16"], None, CLASSIC),
}
# the bf16 solves: Sum/Norm2 within BF16_TOL of stencil5 f64's (a bf16 CG's x is noise at
# ~5e-3 against the exact solution); phase 7 profiles the first of them only
BF16_RUNS = tuple(label for label in CG_RUNS if label.endswith(("bf16", "bf16 classic")))
BF16_TOL = 1e-2
# each bf16 solve beside the f32 (or f64) solve of its mode in the same call
WIDER_RUN = {"stencil5 bf16": "stencil5 f32", "bf16c bf16": "bf16c f32",
             "const bf16 classic": "const f32 classic", "csr bf16": "csr f32",
             "dia bf16": "dia f64", "bcoo bf16": "bcoo f64"}
# the f64 solves whose solution must equal stencil5 f64's (Sum/Norm2 to 1e-10)
HELD_TO_STENCIL5 = ("csr f64", "dia f64", "bcoo f64")
# the SpMV CLI's modes: mode -> kernels required (the plain twins and cuSPARSE need none)
SPMV_NEEDS = {"stencil5": ("spmv_stencil5",), "stencil5-bf16c": ("spmv_stencil5",),
              "stencil5-const": ("spmv_stencil5_const",), "csr": ("spmv_ell",),
              "dia": ("spmv_dia",), "csr-xla": (), "dia-xla": (), "bcoo": (),
              "stencil5-xla": (), "stencil5-const-xla": ()}
SPMV_MODES = ("stencil5", "stencil5-bf16c", "stencil5-const", "csr", "dia", "bcoo")
# the SpMV CLI's plain twins at --dtype=bf16, at G_HOST² (SPMV_MODES run at G_BIG²)
HOST_MODES_BF16 = ("stencil5-xla", "stencil5-const-xla", "csr-xla", "dia-xla")
# the plain twins of the generic kernels, at a grid where they take seconds
HOST_MODES = ("csr", "csr-xla", "dia-xla")
# K5/K6 fields of these sizes and (r, p) offsets in elements into their storage: both
# on a 16-byte boundary (the vector body), one view one element in (the scalar body),
# both one element in (a scalar head before the vectors)
SMALL_N = (1, 3, 1369, 10 ** 6)
ALIGNMENTS = {"aligned": (0, 0), "one offset": (1, 0), "both offset": (1, 1)}
# the fused p-update solves: label -> (mode, dtype name, iterations required, their fused
# pass); each must launch its fused pass, K4 and K6, and none of FUSED_FORBID
FUSED_RUNS = {
    "fused stencil5 f64": ("stencil5", "float64", 14, "spmv_stencil5_pupdate"),
    "fused stencil5 f32": ("stencil5", "float32", None, "spmv_stencil5_pupdate"),
    "fused bf16c f32": ("stencil5-bf16c", "float32", None, "spmv_stencil5_pupdate"),
    "fused const f64": ("stencil5-const", "float64", 14, "spmv_stencil5_const_pupdate"),
    "fused const f32": ("stencil5-const", "float32", None, "spmv_stencil5_const_pupdate"),
}
FUSED_FORBID = ("p_update", "spmv_stencil5", "spmv_stencil5_const",
                "spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute")
FUSED_TIMED = 5  # timed solves of each, after one warm-up
# phase 8: the CG CLI's host-stepped runs and its other flags: label -> (arguments, the
# export's loop, iterations required, kernels required)
TRACE_DIR = OUT / "trace"
STEPPED_RUNS = {
    "stepped stencil5 f64": (["--mode=stencil5", "--dtype=f64", "--timers", "--runs=3",
                              "--warmup=1"], "host-stepped", 14, ("spmv_stencil5",) + CLASSIC),
    "stepped const f32 classic": (["--mode=stencil5-const", "--dtype=f32", "--loop=classic",
                                   "--timers", "--runs=3", "--warmup=1"], "host-stepped",
                                  None, ("spmv_stencil5_const",) + CLASSIC),
    "host stencil5 f64, traced": (["--mode=stencil5", "--dtype=f64", "--host",
                                   f"--trace={TRACE_DIR}"], "host-stepped", 14,
                                  ("spmv_stencil5",) + CLASSIC),
    "device default f64": (["--device", "--dtype=f64", "--runs=3", "--warmup=1"],
                           "fused-classic", 14, ("spmv_stencil5",) + CLASSIC),
}
# phase 9: the multichip CLI at G_BIG² with its ranks sharing the card: label -> (ranks,
# arguments, the export's loop, the phase-5 run whose solution it must equal, kernels every
# rank must launch, kernels every rank with a neighbour must launch on exchanged halo rows)
SHARDED_RUNS = {
    "sharded stencil5 f64 x1": (1, ["--mode=stencil5", "--dtype=f64"], "classic",
                                "stencil5 f64", ("spmv_stencil5",) + CLASSIC, ()),
    "sharded stencil5 f64 x2": (2, ["--mode=stencil5", "--dtype=f64"], "classic",
                                "stencil5 f64", ("spmv_stencil5",) + CLASSIC,
                                ("spmv_stencil5",)),
    "sharded stencil5 f64 x4": (4, ["--mode=stencil5", "--dtype=f64"], "classic",
                                "stencil5 f64", ("spmv_stencil5",) + CLASSIC,
                                ("spmv_stencil5",)),
    "sharded const f64 recompute x4": (4, ["--mode=stencil5-const", "--dtype=f64"],
                                       "recompute-ap", "const f64 recompute", RECOMPUTE,
                                       RECOMPUTE[:2]),
    "sharded csr f64 x4": (4, ["--mode=csr", "--dtype=f64"], "classic", "csr f64",
                           ("spmv_ell",) + CLASSIC, ("spmv_ell",)),
    "sharded stencil5 f64 --timers x4": (4, ["--mode=stencil5", "--dtype=f64", "--timers"],
                                         "host-stepped", "stencil5 f64",
                                         ("spmv_stencil5",) + CLASSIC, ("spmv_stencil5",)),
    "sharded const f64 --timers x4": (4, ["--mode=stencil5-const", "--dtype=f64", "--timers"],
                                      "host-stepped", "const f64 recompute",
                                      ("spmv_stencil5_const",) + CLASSIC,
                                      ("spmv_stencil5_const",)),
    # the bf16 state: any iteration count, Sum/Norm2 within BF16_TOL of stencil5 f64's
    "sharded stencil5 bf16 x2": (2, ["--mode=stencil5", "--dtype=bf16"], "classic",
                                 "stencil5 f64", ("spmv_stencil5",) + CLASSIC,
                                 ("spmv_stencil5",)),
}
SHARDED_ARGS = ["--runs=3", "--warmup=1"]
# phase 10: the multichip CLI's 2-D decomposition at G_BIG² f64, its ranks sharing the card:
# label -> (mesh, arguments, the export's loop, the phase-5 run whose solution it must
# equal, kernels every rank must launch (the first: its SpMV, which takes the exchanged
# rows), the phase-9 row-band run of the same mode on 4 ranks)
STENCIL5_BLOCK = ("spmv_stencil5",) + CLASSIC
MESH2D_RUNS = {
    "mesh2d stencil5 f64 2x2": ((2, 2), ["--mode=stencil5", "--dtype=f64"], "classic",
                                "stencil5 f64", STENCIL5_BLOCK, "sharded stencil5 f64 x4"),
    "mesh2d const f64 2x2": ((2, 2), ["--mode=stencil5-const", "--dtype=f64"], "classic",
                             "const f64 recompute", ("spmv_stencil5_const",) + CLASSIC,
                             "sharded const f64 recompute x4"),
    "mesh2d stencil5 f64 --timers 2x2": ((2, 2), ["--mode=stencil5", "--dtype=f64",
                                                  "--timers"], "host-stepped", "stencil5 f64",
                                         STENCIL5_BLOCK, "sharded stencil5 f64 --timers x4"),
    "mesh2d stencil5 f64 1x4": ((1, 4), ["--mode=stencil5", "--dtype=f64"], "classic",
                                "stencil5 f64", STENCIL5_BLOCK, "sharded stencil5 f64 x4"),
    "mesh2d stencil5 bf16 2x2": ((2, 2), ["--mode=stencil5", "--dtype=bf16"], "classic",
                                 "stencil5 f64", STENCIL5_BLOCK, "sharded stencil5 bf16 x2"),
}
SHARDED_DIR = OUT / "sharded"
# two of phase 5's CLI medians as PERF.md section 6 records them before the solver had
# phase scopes (NVIDIA H100 80GB HBM3, 700.00 W), in ms
RECORDED_MEDIANS = {"stencil5 f64": 255.3, "const f64 recompute": 144.78}
# the solver's phase scopes (bench.profiling), which the profiler lists beside the kernels,
# and the stepped loop's ranges around its reads of the dots
PHASE_NAMES = ("SpMV", "BLAS_AXPY", "BLAS_Update_P", "Dot_Product")
# the streaming probe kernels (kernels/stream_probe.py), which --ceiling-probe launches
PROBE_KERNELS = ("probe_read", "probe_copy")
SCOPE_PAIRS = 100_000  # scopes entered and left to time one on the host
# the least time a call can take: its bytes over HBM's rate, or its operations over the
# peak rate of their type, whichever is larger (NVIDIA's H100 SXM data sheet, dense,
# outside the tensor cores, at the 700 W limit); a bf16 state computes in f32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 67e12}


def rel(a, b) -> float:
    """max |a - b| / max |b|, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def short(name) -> str:
    """A wrapper's short name: K1-K12, or the wrapper's own for the streaming probes."""
    return KERNELS[name][0] if name in KERNELS else name


def k3_scalar_launched(label, counts):
    """Raise if a path launched K3's scalar body (counts: wrapper -> launches)."""
    if counts.get(K3_SCALAR, 0):
        raise AssertionError(f"{label}: K3's scalar body launched {counts[K3_SCALAR]} of "
                             f"{counts['spmv_stencil5_const']} K3 launches on fields aligned "
                             f"for the vector body")


class PathCounts:
    """The launch counts of the main paths, read path by path: every count is set to 0
    just before a path runs and read just after, and the path must have launched each
    kernel it names (K3 through its vector body only)."""

    def __init__(self, counters):
        self.counters = counters
        self.by_path = {}

    def run(self, label, needs, fn, forbid=()):
        for counter in self.counters:
            counter.reset_launches()
        out = fn()
        counts = {name: c.LAUNCHES[name] for c in self.counters for name in c.LAUNCHES
                  if c.LAUNCHES[name]}
        self.by_path[label] = counts
        order = [n for n in KERNELS if n in counts] + [n for n in counts if n not in KERNELS]
        print(f"[launches] {label}: " + ", ".join(f"{short(n)} {counts[n]}" for n in order),
              flush=True)
        missing = [f"{short(n)} {n}" for n in needs if counts.get(n, 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels of this path never launched: {missing}")
        stray = [f"{short(n)} {n}" for n in forbid if counts.get(n, 0)]
        if stray:
            raise AssertionError(f"{label}: kernels of another path launched: {stray}")
        k3_scalar_launched(label, counts)
        return out

    def totals(self):
        """{wrapper: launches summed over the paths}, K3's scalar body's too."""
        return {name: sum(c.get(name, 0) for c in self.by_path.values())
                for name in (*KERNELS, K3_SCALAR)}


class Compare:
    """Kernel-vs-twin comparisons: checks the tolerances (by the state's dtype), keeps
    each kernel's largest absolute and relative errors over all its outputs."""

    def __init__(self, torch):
        # bf16: fields bit for bit (its kernels round as the twins do), f32 dots to 1e-4
        self.tol = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4),
                    torch.bfloat16: (0.0, 1e-4)}
        self.max_abs = {name: 0.0 for name in KERNELS}
        self.max_rel = {name: 0.0 for name in KERNELS}

    def check(self, name, label, dtype, pairs):
        """pairs: [(what, kernel tensor, plain tensor, "field"|"exact"|"dot"), ...]; an
        "exact" field must equal the plain one bit for bit."""
        field_tol, dot_tol = self.tol[dtype]
        parts = []
        for what, k, p, kind in pairs:
            tol = {"field": field_tol, "exact": 0.0, "dot": dot_tol}[kind]
            e = rel(k, p)
            self.max_abs[name] = max(self.max_abs[name], abs_err(k, p))
            self.max_rel[name] = max(self.max_rel[name], e)
            parts.append(f"{what} {e:.3e} (tol {tol:g})")
            if not e <= tol:
                raise AssertionError(f"{KERNELS[name][0]} {label}: {what} rel err {e:.3e} "
                                     f"> {tol:g}")
        print(f"[compare] {KERNELS[name][0]} {label}: " + ", ".join(parts) + " ok",
              flush=True)


def phase_card(torch, sysinfo):
    smi = sysinfo.nvidia_smi()
    if smi is None:
        raise RuntimeError("nvidia-smi did not report the card")
    print(f"[card] {smi}")
    props = torch.cuda.get_device_properties(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: {props.name}, "
          f"sm_{props.major}{props.minor}, {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB, L2 {props.L2_cache_size / 2**20:.0f} MiB",
          flush=True)
    return smi


def _template_args(mangled) -> str:
    # a substitution (S_, S1_, ...) among these arguments can only repeat __nv_bfloat16:
    # builtin types are never substituted
    names = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    return ",".join(names.get(a, "bf16")
                    for a in re.findall(r"13__nv_bfloat16|S\d*_|[fd]", mangled))


def phase_build(build):
    """Build the kernels; print each one's registers and spills (ptxas -v), keep the full
    compiler output in chiprun_out/build_log.txt."""
    build.lib()
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(build.build_log)
    kernel = spills = None
    for ln in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)(?:I(.+?)E)?", ln)
        if m:
            kernel = m.group(1) + (f"<{_template_args(m.group(2))}>" if m.group(2) else "")
            spills = "spills not reported"
        elif kernel and "spill" in ln:
            spills = ln.strip()
        elif kernel and "registers" in ln:
            print(f"[build] {kernel}: {ln.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    how = "built" if build.build_log else "loaded an earlier build of the same sources"
    print(f"[build] {how} in {build.build_seconds:.1f} s: {build.BUILD}", flush=True)


def k3_counts(st5):
    """(K3 launches, of which the scalar body's)."""
    return st5.LAUNCHES["spmv_stencil5_const"], st5.LAUNCHES[K3_SCALAR]


def compare_k3_bodies(torch, st5, cmp, args, label):
    """K3 on the operands args = (x[, halo_prev, halo_next]) against its twin, y bit for
    bit and the dot to tolerance, with and without the dot: through the body the
    alignment rule picks, and through the forced scalar body where that is the vector body;
    each launch must take the body the rule says."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    x = args[0]
    yp, dp = st5.spmv_stencil5_const_plain(*args, with_dot=True, **kw)
    vector = st5.const_vector_fits(*args)
    for scalar in (False, True) if vector else (False,):
        body = "scalar" if scalar or not vector else "vector"
        before = k3_counts(st5)
        y = st5.spmv_stencil5_const(*args, _scalar_body=scalar, **kw)
        yd, d = st5.spmv_stencil5_const(*args, with_dot=True, _scalar_body=scalar, **kw)
        ran = tuple(a - b for a, b in zip(k3_counts(st5), before))
        if ran != (2, 2 if body == "scalar" else 0):
            raise AssertionError(f"K3 {label}: (launches, scalar-body launches) {ran}, "
                                 f"want the {body} body")
        cmp.check("spmv_stencil5_const", f"{label}, {body} body", x.dtype,
                  [("y", y, yp, "exact"), ("y with dot", yd, yp, "exact"),
                   ("dot", d, dp, "dot")])


def compare_const(torch, st5, cmp, g, dtype, randn):
    """K1-K3 against their twins on a g-wide grid and on a band with halo rows (K3 in both
    bodies where the vector body takes the grid: g = 1000, 4096); K3 only for a bf16 state
    (K1 and K2 have no bf16 instance)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    lab = f"g={g} {dname(dtype)}"
    band = g // 2 + 1  # a ragged band of a larger grid, with true neighbour rows
    x, xb = randn(g, g), randn(band, g)
    hp, hn = randn(1, g), randn(1, g)

    compare_k3_bodies(torch, st5, cmp, (x,), lab)
    compare_k3_bodies(torch, st5, cmp, (xb, hp, hn), lab + f" band {band} rows + halos")
    if dtype == torch.bfloat16:
        return

    for beta, halos, rows in ((0.0, (None, None), g), (0.7, (hp, hn), band)):
        r, p = randn(rows, g), randn(rows, g)
        p_before = p.clone()
        b = torch.tensor(beta, dtype=dtype, device=dev)
        pk, dk = st5.spmv_stencil5_const_pupdate_dot(b, r, p, *halos, **kw)
        if not torch.equal(p, p_before):
            raise AssertionError(f"K1 {lab}: the kernel changed its input p")
        pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(b, r, p, *halos, **kw)
        cmp.check("spmv_stencil5_const_pupdate_dot", f"{lab} beta={beta} rows={rows}", dtype,
                  [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])

    x, r, p = randn(band, g), randn(band, g), randn(band, g)
    a = torch.tensor(0.37, dtype=dtype, device=dev)
    xk, rk, dk = st5.cg_const_update_recompute(a, x.clone(), r.clone(), p, hp, hn, **kw)
    xp, rp, dp = st5.cg_const_update_recompute_plain(a, x.clone(), r.clone(), p, hp, hn, **kw)
    cmp.check("cg_const_update_recompute", f"{lab} band {band} rows + halos", dtype,
              [("x'", xk, xp, "field"), ("r'", rk, rp, "field"), ("<r',r'>", dk, dp, "dot")])


def compare_fused(torch, st5, cmp, g, dtype, randn):
    """K9 in its two planes dtypes for this state dtype and K10 against their twins, on a
    g-wide grid for β = 0 with p = 0 (the first iteration) and on a band with halo rows
    for β = 0.7: p' and y bit for bit, the dot to tolerance, p left as it was."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    band = g // 2 + 1
    for beta, rows, halos in ((0.0, g, ()), (0.7, band, (randn(1, g), randn(1, g)))):
        r = randn(rows, g)
        p = torch.zeros_like(r) if beta == 0.0 else randn(rows, g)
        p_before = p.clone()
        b = torch.tensor(beta, dtype=dtype, device=dev)
        lab = f"g={g} {dname(dtype)} beta={beta} rows={rows}" + (" + halos" if halos else "")
        runs = [("spmv_stencil5_const_pupdate", lab,
                 lambda: st5.spmv_stencil5_const_pupdate(b, r, p, *halos, **kw),
                 lambda: st5.spmv_stencil5_const_pupdate_plain(b, r, p, *halos, **kw))]
        for pdt in (dtype, torch.bfloat16):
            planes = randn(5, rows, g).to(pdt)
            runs.append(("spmv_stencil5_pupdate", f"{lab} planes {dname(pdt)}",
                         lambda planes=planes: st5.spmv_stencil5_pupdate(planes, b, r, p,
                                                                         *halos),
                         lambda planes=planes: st5.spmv_stencil5_pupdate_plain(planes, b, r,
                                                                               p, *halos)))
        for name, label, kern, plain in runs:
            pk, yk, dk = kern()
            if not torch.equal(p, p_before):
                raise AssertionError(f"{KERNELS[name][0]} {label}: the kernel changed p")
            pp, yp, dp = plain()
            cmp.check(name, label, dtype, [("p'", pk, pp, "exact"), ("y", yk, yp, "exact"),
                                           ("<p',y>", dk, dp, "dot")])


def compare_k8(torch, st5, cmp, planes, x, halos, label):
    """K8 against its twin on the given operands, with and without the dot."""
    y = st5.spmv_stencil5(planes, x, *halos)
    cmp.check("spmv_stencil5", label, x.dtype,
              [("y", y, st5.spmv_stencil5_plain(planes, x, *halos), "field")])
    del y
    y, d = st5.spmv_stencil5(planes, x, *halos, with_dot=True)
    yp, dp = st5.spmv_stencil5_plain(planes, x, *halos, with_dot=True)
    cmp.check("spmv_stencil5", label + " with dot", x.dtype,
              [("y", y, yp, "field"), ("dot", d, dp, "dot")])


def compare_blas1(torch, blas1, cmp, x, r, p, ap, label):
    """K4-K7 against their twins on the given fields (none of them is changed)."""
    dtype = x.dtype
    a = torch.tensor(0.37, dtype=dtype, device=x.device)
    xk, rk, dk = blas1.cg_update(a, x.clone(), r.clone(), p, ap)
    xp, rp, dp = blas1.cg_update_plain(a, x.clone(), r.clone(), p, ap)
    cmp.check("cg_update", label, dtype,
              [("x'", xk, xp, "field"), ("r'", rk, rp, "field"), ("<r',r'>", dk, dp, "dot")])
    del xk, rk, xp, rp
    pk = blas1.p_update(a, r, p.clone())
    cmp.check("p_update", label, dtype, [("p'", pk, blas1.p_update_plain(a, r, p.clone()),
                                          "exact")])
    del pk
    cmp.check("dot", label, dtype, [("<x,r>", blas1.dot(x, r), blas1.dot_plain(x, r), "dot")])
    zk, dk = blas1.axpby_dot(1.0, x, -1.0, r)
    zp, dp = blas1.axpby_dot_plain(1.0, x, -1.0, r)
    cmp.check("axpby_dot", label, dtype, [("z", zk, zp, "field"), ("<z,z>", dk, dp, "dot")])


def offset_copy(torch, t, offset):
    """A copy of the 1-D field t that lies ``offset`` elements into its own storage."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:]
    return out.copy_(t)


def compare_k5_k6_alignments(torch, blas1, cmp):
    """K5 (p bit for bit) and K6 against their twins on fields of SMALL_N elements at each
    of ALIGNMENTS, so that both bodies, and the vector body's head and tail, run."""
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(5)
        beta = torch.tensor(0.37, dtype=dtype, device=dev)
        for n in SMALL_N:
            for align, (off_r, off_p) in ALIGNMENTS.items():
                r = offset_copy(torch, torch.randn(n, generator=gen, device=dev).to(dtype),
                                off_r)
                p = offset_copy(torch, torch.randn(n, generator=gen, device=dev).to(dtype),
                                off_p)
                body = "vector" if (r.data_ptr() - p.data_ptr()) % 16 == 0 else "scalar"
                if (body == "vector") != (align != "one offset"):
                    raise AssertionError(f"K5/K6 n={n} {align}: unexpected {body} body")
                lab = f"n={n} {align} ({body} body) {dname(dtype)}"
                pk = blas1.p_update(beta, r, offset_copy(torch, p, off_p))
                cmp.check("p_update", lab, dtype,
                          [("p'", pk, blas1.p_update_plain(beta, r, p.clone()), "exact")])
                cmp.check("dot", lab, dtype,
                          [("<r,p>", blas1.dot(r, p), blas1.dot_plain(r, p), "dot")])


def compare_generic(torch, ell, dia, cmp, operands, x, label):
    """K11 and the ELL kernel against their twins on operands = (ELL operand or None, DIA
    operand or None), with and without the dot; y must also be finite."""
    for name, mod, operand in (("spmv_ell", ell, operands[0]), ("spmv_dia", dia, operands[1])):
        if operand is None:
            continue
        kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        y = kern(*operand, x)
        cmp.check(name, label, x.dtype, [("y", y, plain(*operand, x), "field")])
        y, d = kern(*operand, x, with_dot=True)
        yp, dp = plain(*operand, x, with_dot=True)
        cmp.check(name, label + " with dot", x.dtype, [("y", y, yp, "field"),
                                                       ("dot", d, dp, "dot")])
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{KERNELS[name][0]} {label}: y is not finite")


def ell_band(torch, generate, g, lo, hi, dtype):
    """The sharded solver's ELL operand of grid rows [lo, hi): the stencil's band, its
    columns rebased into the gather domain [halo_prev; band; halo_next]."""
    vals, cols = generate.make_stencil5_ell_device(g, DIAG, OFFDIAG, dtype=dtype,
                                                   device="cuda", rows=(lo, hi))
    return vals, cols.sub_(lo * g - g)


def compare_ell_band(torch, ell, generate, cmp, g, dtype, randn):
    """The ELL kernel's rectangular call against its twin: a quarter of the grid's rows
    over its gather domain, the dot from the band's own rows (``dot_offset``)."""
    lo, hi = g // 4, g // 2
    vals, cols = ell_band(torch, generate, g, lo, hi, dtype)
    dom = randn((hi - lo + 2) * g)
    y, d = ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=g)
    yp, dp = ell.spmv_ell_plain(vals, cols, dom, with_dot=True, dot_offset=g)
    cmp.check("spmv_ell", f"g={g} {dname(dtype)} rows [{lo}, {hi}) over their gather domain",
              dtype, [("y", y, yp, "exact"), ("dot", d, dp, "dot")])


def generic_matrices():
    """Phase 3's host matrices, 10^6 rows each, made with vectorized numpy from a seed:
    {label: (ELLMatrix or None, DIAMatrix or None)}."""
    import numpy as np

    from tpusparse_torch import formats

    n = 1_000_000
    rng = np.random.RandomState(11)

    def csr(rows, cols, vals):
        return formats.coo_to_csr(formats.COOMatrix(n, n, rows, cols, vals))

    # random banded: 1..9 entries a row at columns within 64 of the diagonal
    rows = np.repeat(np.arange(n, dtype=np.int64), rng.randint(1, 10, n))
    cols = np.clip(rows + rng.randint(-64, 65, rows.size), 0, n - 1)
    vals = rng.randn(rows.size)
    band = csr(rows, cols, vals)
    keep = rows % 3 != 0  # the same without every third row
    holes = csr(rows[keep], cols[keep], vals[keep])
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    scattered = csr(rows, rng.randint(0, n, 3 * n).astype(np.int64), rng.randn(3 * n))
    i = np.arange(n, dtype=np.int64)
    diagonal = csr(i, i, rng.randn(n))
    # offsets ±300 and ±1000, NaN wherever a diagonal leaves the matrix: a product with a
    # padded zero would carry it into y, a select does not
    offsets = np.array([-1000, -300, 0, 300, 1000], dtype=np.int64)
    data = rng.randn(offsets.size, n)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n)] = np.nan
    far = formats.DIAMatrix(num_rows=n, num_cols=n, offsets=offsets, data=data)
    return {
        "random banded": (formats.csr_to_ell(band), formats.csr_to_dia(band)),
        "uniformly random columns": (formats.csr_to_ell(scattered), None),
        "width-1 diagonal": (formats.csr_to_ell(diagonal), formats.csr_to_dia(diagonal)),
        "every third row empty": (formats.csr_to_ell(holes), formats.csr_to_dia(holes)),
        "DIA offsets ±300 ±1000, NaN off the matrix": (None, far),
    }


def compare_bf16(torch, st5, blas1, ell, dia, cmp, g):
    """The bf16-state instances against their twins on a g-wide grid (seeded normal values
    rounded to bf16): K3 and K8 (bf16 planes) on the grid and on a band with halo rows,
    K4-K7, K11 and the ELL kernel on the stencil's operands, and the ELL kernel's
    rectangular call; fields bit for bit, dots (f32) to 1e-4."""
    from tpusparse_torch import generate

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(g + 16)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    compare_const(torch, st5, cmp, g, bf, randn)
    lab = f"g={g} bfloat16"
    compare_blas1(torch, blas1, cmp, *(randn(g, g) for _ in range(4)), lab)
    band = g // 2 + 1
    pl = f"g={g} planes bfloat16 state bfloat16"
    compare_k8(torch, st5, cmp, randn(5, g, g), randn(g, g), (), pl)
    compare_k8(torch, st5, cmp, randn(5, band, g), randn(band, g),
               (randn(1, g), randn(1, g)), pl + f" band {band} rows + halos")
    compare_generic(torch, ell, dia, cmp, (
        generate.make_stencil5_ell_device(g, DIAG, OFFDIAG, dtype=bf, device=dev),
        generate.make_stencil5_dia_device(g, DIAG, OFFDIAG, dtype=bf, device=dev)),
        randn(g * g), f"stencil {lab}")
    compare_ell_band(torch, ell, generate, cmp, g, bf, randn)


def phase_compare(torch, st5, blas1, ell, dia, cmp):
    from tpusparse_torch import convert, generate

    dev = torch.device("cuda")
    for g in GRIDS:
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device=dev).manual_seed(g)

            def randn(*shape):
                return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

            compare_const(torch, st5, cmp, g, dtype, randn)
            compare_fused(torch, st5, cmp, g, dtype, randn)
            lab = f"g={g} {dname(dtype)}"
            compare_blas1(torch, blas1, cmp, *(randn(g, g) for _ in range(4)), lab)
            band = g // 2 + 1
            for pdt in (dtype, torch.bfloat16):
                pl = f"g={g} planes {dname(pdt)} state {dname(dtype)}"
                compare_k8(torch, st5, cmp, randn(5, g, g).to(pdt), randn(g, g), (), pl)
                compare_k8(torch, st5, cmp, randn(5, band, g).to(pdt), randn(band, g),
                           (randn(1, g), randn(1, g)), pl + f" band {band} rows + halos")
            compare_generic(torch, ell, dia, cmp, (
                generate.make_stencil5_ell_device(g, DIAG, OFFDIAG, dtype=dtype, device=dev),
                generate.make_stencil5_dia_device(g, DIAG, OFFDIAG, dtype=dtype, device=dev)),
                randn(g * g), f"stencil {lab}")
            compare_ell_band(torch, ell, generate, cmp, g, dtype, randn)
        compare_bf16(torch, st5, blas1, ell, dia, cmp, g)
    compare_k5_k6_alignments(torch, blas1, cmp)
    t0 = time.perf_counter()
    mats = generic_matrices()
    print(f"[compare] host matrices of 10^6 rows built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(3)
        for label, (e, d) in mats.items():
            operands = (None if e is None else convert.ell_from_numpy(e.col, e.val, dtype, dev),
                        None if d is None else convert.dia_from_numpy(d.data, d.offsets, dtype,
                                                                      dev))
            n = (e or d).num_rows
            x = torch.randn(n, generator=gen, device=dev, dtype=dtype)
            width = f"W={e.width}" if e is not None else f"ndiag={d.ndiag}"
            compare_generic(torch, ell, dia, cmp, operands, x,
                            f"{label} n={n} {width} {dname(dtype)}")
    torch.cuda.synchronize()


def phase_checksum(torch, st5, ell, dia, generate):
    want = generate.stencil5_spmv_checksums(G_BIG, DIAG, OFFDIAG)

    def check(label, y):
        y = y.double()
        got = (float(y.sum()), float(torch.linalg.vector_norm(y)))
        for what, a, b in (("sum", got[0], want[0]), ("norm", got[1], want[1])):
            if abs(a - b) > 1e-12 * abs(b):
                raise AssertionError(f"checksum {what} {label}: {a!r} != {b!r}")
        print(f"[checksum] {label}: sum {got[0]!r} norm {got[1]!r} (analytic {want[0]!r} "
              f"{want[1]!r}) ok", flush=True)

    for dtype in (torch.float32, torch.float64):
        x = generate.ones_field(G_BIG, dtype, "cuda")
        zero = torch.zeros_like(x)
        check(f"K3 {G_BIG}² {dname(dtype)}",
              st5.spmv_stencil5_const(x, diag=DIAG, offdiag=OFFDIAG))
        check(f"K10 {G_BIG}² {dname(dtype)} beta=0 p=0",
              st5.spmv_stencil5_const_pupdate(0.0, x, zero, diag=DIAG, offdiag=OFFDIAG)[1])
        for pdt in (dtype, torch.bfloat16) if dtype == torch.float32 else (dtype,):
            planes = generate.make_stencil5_planes_device(G_BIG, DIAG, OFFDIAG, dtype=pdt,
                                                          device="cuda")
            check(f"K8 {G_BIG}² planes {dname(pdt)} state {dname(dtype)}",
                  st5.spmv_stencil5(planes, x))
            check(f"K9 {G_BIG}² planes {dname(pdt)} state {dname(dtype)} beta=0 p=0",
                  st5.spmv_stencil5_pupdate(planes, 0.0, x, zero)[1])
            del planes
        del zero
        for short, spmv, make in (("ELL", ell.spmv_ell, generate.make_stencil5_ell_device),
                                  ("K11", dia.spmv_dia, generate.make_stencil5_dia_device)):
            operand = make(G_BIG, DIAG, OFFDIAG, dtype=dtype, device="cuda")
            check(f"{short} {G_BIG}² {dname(dtype)}", spmv(*operand, x.reshape(-1)))
            del operand
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
    # the bf16 state: y = 1, 2 or 3 at every point, exact in bf16, summed in f64
    bf = torch.bfloat16
    x = generate.ones_field(G_BIG, bf, "cuda")
    check(f"K3 {G_BIG}² bfloat16", st5.spmv_stencil5_const(x, diag=DIAG, offdiag=OFFDIAG))
    planes = generate.make_stencil5_planes_device(G_BIG, DIAG, OFFDIAG, dtype=bf,
                                                  device="cuda")
    check(f"K8 {G_BIG}² planes bfloat16 state bfloat16", st5.spmv_stencil5(planes, x))
    del planes
    for short, spmv, make in (("ELL", ell.spmv_ell, generate.make_stencil5_ell_device),
                              ("K11", dia.spmv_dia, generate.make_stencil5_dia_device)):
        operand = make(G_BIG, DIAG, OFFDIAG, dtype=bf, device="cuda")
        check(f"{short} {G_BIG}² bfloat16", spmv(*operand, x.reshape(-1)))
        del operand
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


def phase_main_path(torch, counters, cg_cli, spmv_cli):
    """The main paths through the entry points a user calls, each with its own launch
    counts.  Returns ({label: CG export}, {label: fused solve's median ms, iterations},
    {wrapper: launches summed over the paths})."""
    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg

    OUT.mkdir(exist_ok=True)
    counts = PathCounts(counters)
    results = {}
    for label, (mode, extra, iters, needs) in CG_RUNS.items():
        path = OUT / f"chip_smoke_cg_{label.replace(' ', '_')}.json"
        rc = counts.run(f"cg {label}", needs, lambda: cg_cli.main(
            [f"gen:{G_BIG}", f"--mode={mode}", *extra, f"--json={path}"]))
        res = json.loads(path.read_text())
        its = res["convergence"]["iterations"]
        print(f"[cg] {label}: rc {rc}, mode {mode}, loop {res['loop']}, converged "
              f"{res['convergence']['converged']}, {its} iterations, median "
              f"{res['timing']['total_median_ms']!r} ms", flush=True)
        if rc != 0 or not res["convergence"]["converged"]:
            raise AssertionError(f"CG {label} at {G_BIG}² did not converge (rc {rc})")
        if iters is not None and its != iters:
            raise AssertionError(f"CG {label} at {G_BIG}² took {its} iterations, not {iters}")
        results[label] = res
    if results["bf16c f32"]["validation"] != results["stencil5 f32"]["validation"]:
        raise AssertionError(f"CG checksums of bf16c and stencil5 f32 differ: "
                             f"{results['bf16c f32']['validation']} vs "
                             f"{results['stencil5 f32']['validation']}")
    ref = results["stencil5 f64"]["validation"]
    for label in HELD_TO_STENCIL5:
        v = results[label]["validation"]
        errs = {k: abs(v[k] - ref[k]) / abs(ref[k]) for k in ("solution_sum", "solution_norm")}
        print(f"[cg] {label} solution against stencil5 f64: Sum rel {errs['solution_sum']:.3e}, "
              f"Norm2 rel {errs['solution_norm']:.3e} (tol 1e-10)", flush=True)
        if not max(errs.values()) <= 1e-10:
            raise AssertionError(f"CG {label} solution differs from stencil5 f64's: {errs}")
    for label in BF16_RUNS:
        v = results[label]["validation"]
        errs = {k: abs(v[k] - ref[k]) / abs(ref[k]) for k in ("solution_sum", "solution_norm")}
        f32 = results[WIDER_RUN[label]]
        print(f"[cg] {label} solution against stencil5 f64: Sum rel {errs['solution_sum']:.3e}, "
              f"Norm2 rel {errs['solution_norm']:.3e} (tol {BF16_TOL:g}); "
              f"{results[label]['convergence']['iterations']} iterations, median "
              f"{results[label]['timing']['total_median_ms']!r} ms against {WIDER_RUN[label]}'s "
              f"{f32['convergence']['iterations']} iterations, "
              f"{f32['timing']['total_median_ms']!r} ms in the same call", flush=True)
        if not max(errs.values()) <= BF16_TOL:
            raise AssertionError(f"CG {label} solution differs from stencil5 f64's: {errs}")
    # --loop=auto picks the recompute loop on stencil5-const, which refuses a bf16 state
    rc = counts.run("cg const bf16 --loop=auto (refused)", (), lambda: cg_cli.main(
        [f"gen:{G_BIG}", "--mode=stencil5-const", "--dtype=bf16"]))
    print(f"[cg] stencil5-const --dtype=bf16 --loop=auto: rc {rc} (want 2)", flush=True)
    if rc != 2:
        raise AssertionError(f"cg_solver --mode=stencil5-const --dtype=bf16: rc {rc}, not 2")

    kernel_ms = run_spmv_cli(spmv_cli, counts, G_BIG, SPMV_MODES, "chip_smoke_spmv.json")
    print(f"[spmv] csr / stencil5 SpMV kernel time at {G_BIG}² f32: "
          f"{kernel_ms['csr'] / kernel_ms['stencil5']!r} (the reference's CSR / STENCIL5: "
          f"2.07 on its A100); bcoo (cuSPARSE) / csr: "
          f"{kernel_ms['bcoo'] / kernel_ms['csr']!r}", flush=True)
    run_spmv_cli(spmv_cli, counts, G_BIG, ("bcoo",), "chip_smoke_spmv_f64.json", "f64")
    # x stays on the card: each transfer-inclusive run would spend ~1 s moving x and y
    run_spmv_cli(spmv_cli, counts, G_BIG, SPMV_MODES, "chip_smoke_spmv_bf16.json", "bf16",
                 ("--resident-x",))
    run_spmv_cli(spmv_cli, counts, G_HOST, HOST_MODES_BF16, "chip_smoke_spmv_host_bf16.json",
                 "bf16")
    run_spmv_cli(spmv_cli, counts, G_HOST, HOST_MODES, "chip_smoke_spmv_host.json")

    # the values-carrying solves' solutions, bit for bit: bf16 planes against f32 planes
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    xs = {}
    for mode in ("stencil5", "stencil5-bf16c"):
        op = ops.get_operator(mode, st, dtype=torch.float32, device="cuda")
        xs[mode], s = counts.run(f"cg_solve {mode} f32", ("spmv_stencil5",) + CLASSIC,
                                 lambda: cg.cg_solve(op, b_is_ones=True))
        op.free()
        print(f"[cg] {mode} f32 cg_solve: {s.iterations} iterations", flush=True)
    if not torch.equal(xs["stencil5"], xs["stencil5-bf16c"]):
        raise AssertionError("stencil5-bf16c's x differs from stencil5 f32's x")
    print(f"[cg] stencil5-bf16c x equals stencil5 f32 x bit for bit at {G_BIG}²", flush=True)
    x_zero = xs.pop("stencil5")
    del xs

    # a seeded nonzero x0: r0 = b - A·x0 through K7.  Both solutions must meet the
    # tolerance on the true residual ‖b - A·x‖ / ‖b‖, formed in f64 by the constant
    # stencil's twin (the same matrix); an f32 solve ends near 1e-6 of it
    def true_residual(x):
        xd = x.double()
        ax = st5.spmv_stencil5_const_plain(xd, diag=DIAG, offdiag=OFFDIAG)
        return float(torch.linalg.vector_norm(ax.sub_(1.0))) / G_BIG  # ‖b‖ = g

    op = ops.get_operator("stencil5", st, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x0 = torch.randn(G_BIG, G_BIG, generator=gen, device="cuda", dtype=torch.float32)
    x, s = counts.run("cg_solve stencil5 f32 from a seeded x0",
                      ("spmv_stencil5", "axpby_dot") + CLASSIC,
                      lambda: cg.cg_solve(op, op.ones_b(), x0))
    op.free()
    del x0
    res, res_zero = true_residual(x), true_residual(x_zero)
    print(f"[cg] stencil5 f32 from a seeded x0: converged {s.converged}, {s.iterations} "
          f"iterations, true residual {res:.3e} (from x0 = 0: {res_zero:.3e})", flush=True)
    if not (s.converged and res < 1e-5 and res_zero < 1e-5):
        raise AssertionError("CG from a nonzero x0 did not solve the system")
    del x, x_zero
    torch.cuda.empty_cache()
    # the same at a bf16 state (r0 through K7's bf16 instance), its x held to stencil5
    # f64's as the bf16 CLI runs are
    op = ops.get_operator("stencil5", st, dtype=torch.bfloat16, device="cuda")
    x0 = torch.randn(G_BIG, G_BIG, generator=gen, device="cuda").to(torch.bfloat16)
    x, s = counts.run("cg_solve stencil5 bf16 from a seeded x0",
                      ("spmv_stencil5", "axpby_dot") + CLASSIC,
                      lambda: cg.cg_solve(op, op.ones_b(), x0))
    op.free()
    del x0
    xd = x.double()
    ref = results["stencil5 f64"]["validation"]
    errs = {"solution_sum": abs(float(xd.sum()) - ref["solution_sum"]) / ref["solution_sum"],
            "solution_norm": abs(float(torch.linalg.vector_norm(xd)) - ref["solution_norm"])
            / ref["solution_norm"]}
    print(f"[cg] stencil5 bf16 from a seeded x0: converged {s.converged}, {s.iterations} "
          f"iterations, Sum rel {errs['solution_sum']:.3e}, Norm2 rel "
          f"{errs['solution_norm']:.3e} against stencil5 f64 (tol {BF16_TOL:g})", flush=True)
    if not (s.converged and max(errs.values()) <= BF16_TOL):
        raise AssertionError(f"bf16 CG from a nonzero x0: converged {s.converged}, {errs}")
    del x, xd
    torch.cuda.empty_cache()

    fused = phase_fused(torch, counts, st, results)
    launches = counts.totals()
    (OUT / "chip_smoke_launches.json").write_text(json.dumps(counts.by_path, indent=1))
    missing = [f"{KERNELS[n][0]} {n}" for n in KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    return results, fused, launches


def phase_fused(torch, counts, st, results):
    """The fused p-update solves through cg.cg_solve(fused_pupdate=True), each path with
    its own launch counts: one warm-up, then FUSED_TIMED timed solves (the port's stats:
    the median).  Returns {label: (median ms, iterations)}."""
    from tpusparse_torch import ops
    from tpusparse_torch.bench import stats
    from tpusparse_torch.solvers import cg

    out, x_f32 = {}, None
    for label, (mode, dtype_name, iters, fused_pass) in FUSED_RUNS.items():
        dtype = getattr(torch, dtype_name)
        op = ops.get_operator(mode, st, dtype=dtype, device="cuda")

        def solve():
            t0 = time.perf_counter()
            x, s = cg.cg_solve(op, b_is_ones=True, fused_pupdate=True)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, (x, s)

        bench, (x, s) = counts.run(
            label, (fused_pass, "cg_update", "dot"),
            lambda: stats.benchmark_solver_with_stats(solve, num_runs=FUSED_TIMED, warmup=1),
            forbid=FUSED_FORBID)
        op.free()
        del op
        xd = x.double()
        check = {"solution_sum": float(xd.sum()),
                 "solution_norm": float(torch.linalg.vector_norm(xd))}
        del xd
        print(f"[cg] {label} {G_BIG}²: converged {s.converged}, {s.iterations} iterations, "
              f"median {bench.median_ms!r} ms over {bench.valid_runs}/{bench.total_runs} "
              f"runs, Sum {check['solution_sum']!r} Norm2 {check['solution_norm']!r}",
              flush=True)
        if not s.converged or (iters is not None and s.iterations != iters):
            raise AssertionError(f"{label}: converged {s.converged} in {s.iterations} "
                                 f"iterations, not {iters}")
        ref_label = {"fused stencil5 f64": "stencil5 f64",
                     "fused const f64": "const f64 recompute"}.get(label)
        if ref_label:
            ref = results[ref_label]["validation"]
            errs = {k: abs(check[k] - ref[k]) / abs(ref[k]) for k in check}
            print(f"[cg] {label} against the {ref_label} solution: Sum rel "
                  f"{errs['solution_sum']:.3e}, Norm2 rel {errs['solution_norm']:.3e} "
                  f"(tol 1e-10)", flush=True)
            if not max(errs.values()) <= 1e-10:
                raise AssertionError(f"{label} differs from {ref_label}: {errs}")
        if label == "fused stencil5 f32":
            x_f32 = x
        elif label == "fused bf16c f32":
            if not torch.equal(x, x_f32):
                raise AssertionError("fused stencil5-bf16c's x differs from fused stencil5 "
                                     "f32's x")
            print(f"[cg] fused stencil5-bf16c x equals fused stencil5 f32 x bit for bit at "
                  f"{G_BIG}²", flush=True)
            x_f32 = None
        out[label] = (bench.median_ms, s.iterations)
        del x
        torch.cuda.empty_cache()
    return out


def run_spmv_cli(spmv_cli, counts, g, modes, name, dtype="f32", extra=()):
    """The SpMV CLI at gen:g in ``dtype`` with ``extra`` arguments, one run per mode, each
    with its own launch counts; the wall time of a run includes its operator's build.  Raises unless every
    mode gives the same checksums, and those of y = A·ones to 1e-12 (``generate.
    stencil5_spmv_checksums``).  Returns {mode: kernel ms}."""
    from tpusparse_torch import generate

    want = generate.stencil5_spmv_checksums(g, DIAG, OFFDIAG)
    spmv_json = OUT / name
    sums, kernel_ms = {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        rc = counts.run(f"spmv {mode} {g}² {dtype}", SPMV_NEEDS[mode], lambda: spmv_cli.main(
            [f"gen:{g}", f"--mode={mode}", f"--dtype={dtype}", "--runs=3", "--warmup=1",
             *extra, f"--json={spmv_json}"]))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"spmv_bench --mode={mode} at {g}²: rc {rc}")
        b = json.loads(spmv_json.with_name(f"{spmv_json.stem}_{mode}.json").read_text())[
            "benchmark"]
        sums[mode] = (b["validation"]["sum_y"], b["validation"]["norm2_y"])
        p = b["performance"]
        kernel_ms[mode] = p["time_kernel_ms"]
        print(f"[spmv] {mode} {g}² {dtype}: kernel {p['time_kernel_ms']!r} ms, "
              f"{p['bandwidth_gbs']!r} GB/s (roofline share {p['roofline_fraction']!r}), "
              f"run median {p['time_median_ms']!r} ms, sum {sums[mode][0]!r} norm "
              f"{sums[mode][1]!r} (analytic {want[0]!r} {want[1]!r}); the CLI run with its "
              f"operator's build {wall:.1f} s", flush=True)
        if max(abs(a - b) / abs(b) for a, b in zip(sums[mode], want)) > 1e-12:
            raise AssertionError(f"spmv_bench --mode={mode} at {g}² {dtype}: checksums "
                                 f"{sums[mode]} against the analytic {want}")
    if len(set(sums.values())) != 1:
        raise AssertionError(f"spmv_bench at {g}²: checksums differ across modes: {sums}")
    return kernel_ms


def _time_ms(torch, fn, n=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(work, key):
    """(ms, "bytes"|"operations"): the least time of a call that moves work[0] bytes (each
    input read once, each output written once) and does work[1] operations of the state
    type of ``key`` ("f32", "f64", "bf16", "bf16_f32", ...: planes_state)."""
    nb, ops = work
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[key.split("_")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_library(torch, e, kern, lib):
    """Time a kernel against its library call (kernel/library/library/kernel) into the
    timing entry e: the best library time, and the kernel's best of these and e's."""
    t_k1, t_l1, t_l2, t_k2 = (_time_ms(torch, f) for f in (kern, lib, lib, kern))
    e["ms"], e["library_ms"] = min(e["ms"], t_k1, t_k2), min(t_l1, t_l2)


def _time_pairs(torch, times, key, pairs, label, smi):
    """Time each kernel against its plain twin (plain/kernel/kernel/plain) and, where it
    has one, against its library call (kernel/library/library/kernel); keep the best of
    each, beside the kernel's bound.  pairs: {name: (kernel, plain, (bytes, operations),
    library call or None)}."""
    for name, (kern, plain, work, lib) in pairs.items():
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(torch, f) for f in (plain, kern, kern, plain))
        e = {"ms": min(t_k1, t_k2), "plain_ms": min(t_p1, t_p2), "library_ms": None}
        if lib is not None:
            _time_library(torch, e, kern, lib)
        e["bound_ms"], e["bound_by"] = bound(work, key)
        times[name][key] = e
        lib_txt = "" if lib is None else f", library {e['library_ms']!r} ms"
        print(f"[time] {KERNELS[name][0]} {name} {label}: kernel {e['ms']!r} ms, plain "
              f"{e['plain_ms']!r} ms{lib_txt}, bound {e['bound_ms']!r} ms ({e['bound_by']}; "
              f"kernel at {100 * e['bound_ms'] / e['ms']:.1f}% of it) [{smi}]", flush=True)


def check_library(name, label, got, want, tol=1e-5):
    """A library call against the kernel: a yardstick held to ``tol`` relative (1e-5; 1e-2
    at a bf16 state, where it rounds once, or its sum to bf16, where the kernel rounds
    each operation), not an oracle (it sums in another order)."""
    e = rel(got.reshape(want.shape), want)
    print(f"[library] {KERNELS[name][0]} {label}: rel err {e:.3e} against the kernel "
          f"(tol {tol:g})", flush=True)
    if not e <= tol:
        raise AssertionError(f"library call of {name} {label}: rel err {e:.3e}")


def time_k3_bodies(torch, run, work, key, label, smi):
    """K3's vector body against its forced scalar body on the same operands, in turns
    (vector/scalar/scalar/vector); ``run(scalar)`` makes the call.  Prints both beside the
    bound; returns (vector ms, scalar ms), each the better of its two."""
    t = [_time_ms(torch, lambda sc=sc: run(sc)) for sc in (False, True, True, False)]
    vector, scalar = min(t[0], t[3]), min(t[1], t[2])
    b, by = bound(work, key)
    print(f"[time] K3 bodies {label}: vector {vector!r} ms ({100 * b / vector:.1f}% of the "
          f"bound), scalar {scalar!r} ms ({100 * b / scalar:.1f}%), bound {b!r} ms ({by}); "
          f"scalar / vector {scalar / vector:.3f} [{smi}]", flush=True)
    return vector, scalar


def k3_entry(ms, work, key, plain_ms=None, library_ms=None):
    """A timing entry of K3 (one body, one shape) beside its bound."""
    b, by = bound(work, key)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b,
            "bound_by": by}


def time_k3(torch, st5, times, x, key, label, smi):
    """K3 at G_BIG² after _time_pairs timed its vector body: the forced scalar body in turns
    with the vector body (its entry: key "scalar_" + key, with the same twin and library
    times)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    work = (2 * nbytes(x), 6 * x.numel())
    e = times["spmv_stencil5_const"]
    _vector, scalar = time_k3_bodies(
        torch, lambda sc: st5.spmv_stencil5_const(x, _scalar_body=sc, **kw), work, key,
        label, smi)
    e[f"scalar_{key}"] = k3_entry(scalar, work, key, e[key]["plain_ms"], e[key]["library_ms"])


def phase_full_size(torch, st5, blas1, cmp, smi):
    """Each kernel against its twin at G_BIG² on seeded random fields, at the main paths'
    shapes (no halo rows, β ≠ 0), then timed against it, and against its library call,
    on the same inputs.  Returns {wrapper: {key: {"ms", "plain_ms", "library_ms",
    "bound_ms", "bound_by"}}}, key "f32"/"f64" (K8 and K9 also "bf16_f32", "bf16_f64":
    planes_state)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    n = G_BIG * G_BIG
    times = {name: {} for name in KERNELS}
    for dtype in (torch.float32, torch.float64):
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(0)
        x, r, p = (torch.rand(G_BIG, G_BIG, generator=gen, device=dev, dtype=dtype)
                   for _ in range(3))
        pout = torch.empty_like(p)
        s = torch.tensor(0.37, dtype=dtype, device=dev)
        key = dname(dtype).replace("float", "f")
        lab = f"{G_BIG}² {dname(dtype)}"

        compare_k3_bodies(torch, st5, cmp, (x,), lab)
        y = st5.spmv_stencil5_const(x, **kw)
        # the 3×3 stencil as a convolution with zero padding: the constant operator
        w = torch.tensor([[0.0, OFFDIAG, 0.0], [OFFDIAG, DIAG, OFFDIAG], [0.0, OFFDIAG, 0.0]],
                         dtype=dtype, device=dev).reshape(1, 1, 3, 3)

        def conv():
            return F.conv2d(x.reshape(1, 1, G_BIG, G_BIG), w, padding=1)

        check_library("spmv_stencil5_const", f"F.conv2d {lab}", conv(), y)
        p_before = p.clone()
        pk, dk = st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, **kw)
        if not torch.equal(p, p_before):
            raise AssertionError(f"K1 {lab}: the kernel changed its input p")
        del p_before
        pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, **kw)
        cmp.check("spmv_stencil5_const_pupdate_dot", f"{lab} beta=0.37", dtype,
                  [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])
        del pp
        pk, yk, dk = st5.spmv_stencil5_const_pupdate(s, r, p, out=pout, **kw)
        pp, yp, dp = st5.spmv_stencil5_const_pupdate_plain(s, r, p, **kw)
        cmp.check("spmv_stencil5_const_pupdate", f"{lab} beta=0.37", dtype,
                  [("p'", pk, pp, "exact"), ("y", yk, yp, "exact"), ("<p',y>", dk, dp, "dot")])
        del pp, yp, yk
        xk, rk, dk = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p, **kw)
        xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p, **kw)
        cmp.check("cg_const_update_recompute", lab, dtype,
                  [("x'", xk, xp, "field"), ("r'", rk, rp, "field"),
                   ("<r',r'>", dk, dp, "dot")])
        del xk, rk, xp, rp
        # y = A·x stands in for Ap in the classic loop's K4
        compare_blas1(torch, blas1, cmp, x, r, p, y, lab)
        check_library("p_update", f"torch.add {lab}", torch.add(r, p, alpha=0.37),
                      blas1.p_update(s, r, p.clone()))
        check_library("dot", f"torch.dot {lab}", torch.dot(x.reshape(-1), r.reshape(-1)),
                      blas1.dot(x, r))

        f = nbytes(x)  # one field
        _time_pairs(torch, times, key, {
            "spmv_stencil5_const": (
                lambda: st5.spmv_stencil5_const(x, **kw),
                lambda: st5.spmv_stencil5_const_plain(x, **kw), (2 * f, 6 * n), conv),
            "spmv_stencil5_const_pupdate_dot": (
                lambda: st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, **kw),
                lambda: st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, out=pout, **kw),
                (3 * f, 10 * n), None),
            "spmv_stencil5_const_pupdate": (
                lambda: st5.spmv_stencil5_const_pupdate(s, r, p, out=pout, **kw),
                lambda: st5.spmv_stencil5_const_pupdate_plain(s, r, p, out=pout, **kw),
                (4 * f, 10 * n), None),
            "cg_const_update_recompute": (
                lambda: st5.cg_const_update_recompute(s, x, r, p, **kw),
                lambda: st5.cg_const_update_recompute_plain(s, x, r, p, **kw),
                (5 * f, 12 * n), None),
            "cg_update": (lambda: blas1.cg_update(s, x, r, p, y),
                          lambda: blas1.cg_update_plain(s, x, r, p, y), (6 * f, 6 * n), None),
            "p_update": (lambda: blas1.p_update(s, r, p), lambda: blas1.p_update_plain(s, r, p),
                         (3 * f, 2 * n), lambda: torch.add(r, p, alpha=0.37)),
            "dot": (lambda: blas1.dot(x, r), lambda: blas1.dot_plain(x, r), (2 * f, 2 * n),
                    lambda: torch.dot(x.reshape(-1), r.reshape(-1))),
            "axpby_dot": (lambda: blas1.axpby_dot(1.0, x, -1.0, r),
                          lambda: blas1.axpby_dot_plain(1.0, x, -1.0, r), (3 * f, 5 * n), None),
        }, lab, smi)
        time_k3(torch, st5, times, x, key, lab, smi)
        del y, pk
        for pdt in (dtype, torch.bfloat16):
            torch.cuda.empty_cache()
            planes = torch.rand(5, G_BIG, G_BIG, generator=gen, device=dev, dtype=dtype).to(pdt)
            pl = f"{G_BIG}² planes {dname(pdt)} state {dname(dtype)}"
            compare_k8(torch, st5, cmp, planes, x, (), pl)
            pk, yk, dk = st5.spmv_stencil5_pupdate(planes, s, r, p, out=pout)
            pp, yp, dp = st5.spmv_stencil5_pupdate_plain(planes, s, r, p)
            cmp.check("spmv_stencil5_pupdate", f"{pl} beta=0.37", dtype,
                      [("p'", pk, pp, "exact"), ("y", yk, yp, "exact"),
                       ("<p',y>", dk, dp, "dot")])
            del pk, yk, pp, yp
            pkey = key if pdt == dtype else f"bf16_{key}"
            _time_pairs(torch, times, pkey, {
                "spmv_stencil5": (lambda: st5.spmv_stencil5(planes, x),
                                  lambda: st5.spmv_stencil5_plain(planes, x),
                                  (nbytes(planes) + 2 * f, 9 * n), None),
                "spmv_stencil5_pupdate": (
                    lambda: st5.spmv_stencil5_pupdate(planes, s, r, p, out=pout),
                    lambda: st5.spmv_stencil5_pupdate_plain(planes, s, r, p, out=pout),
                    (nbytes(planes) + 4 * f, 13 * n), None),
            }, pl, smi)
            del planes
        del x, r, p, pout
    torch.cuda.empty_cache()
    return times


def phase_full_size_bf16(torch, st5, blas1, cmp, smi, times):
    """The bf16-state instances of K3-K8 at G_BIG² against their twins (fields bit for
    bit, f32 dots to 1e-4) on seeded uniform values rounded to bf16, at the main paths'
    shapes, then timed against the twin and against the bf16 library call where there is
    one: F.conv2d in bf16 for K3, torch.add(r, p, alpha=β) and torch.dot on bf16 for K5
    and K6 (held to the kernel at 1e-2: ``check_library``).  Adds key "bf16" (K8:
    "bf16_bf16", planes_state) to ``times``."""
    import torch.nn.functional as F

    dev, bf = torch.device("cuda"), torch.bfloat16
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    n = G_BIG * G_BIG
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    x, r, p = (torch.rand(G_BIG, G_BIG, generator=gen, device=dev, dtype=bf)
               for _ in range(3))
    s = torch.tensor(0.37, dtype=bf, device=dev)
    beta = float(s)  # the library calls take β as the kernels do, rounded to bf16
    lab = f"{G_BIG}² bfloat16"
    compare_k3_bodies(torch, st5, cmp, (x,), lab)
    y = st5.spmv_stencil5_const(x, **kw)
    w = torch.tensor([[0.0, OFFDIAG, 0.0], [OFFDIAG, DIAG, OFFDIAG], [0.0, OFFDIAG, 0.0]],
                     dtype=bf, device=dev).reshape(1, 1, 3, 3)

    def conv():
        return F.conv2d(x.reshape(1, 1, G_BIG, G_BIG), w, padding=1)

    check_library("spmv_stencil5_const", f"F.conv2d {lab}", conv(), y, tol=BF16_TOL)
    # y = A·x stands in for Ap in the classic loop's K4
    compare_blas1(torch, blas1, cmp, x, r, p, y, lab)
    check_library("p_update", f"torch.add {lab}", torch.add(r, p, alpha=beta),
                  blas1.p_update(s, r, p.clone()), tol=BF16_TOL)
    check_library("dot", f"torch.dot {lab}", torch.dot(x.reshape(-1), r.reshape(-1)),
                  blas1.dot(x, r), tol=BF16_TOL)
    f = nbytes(x)
    _time_pairs(torch, times, "bf16", {
        "spmv_stencil5_const": (lambda: st5.spmv_stencil5_const(x, **kw),
                                lambda: st5.spmv_stencil5_const_plain(x, **kw),
                                (2 * f, 6 * n), conv),
        "cg_update": (lambda: blas1.cg_update(s, x, r, p, y),
                      lambda: blas1.cg_update_plain(s, x, r, p, y), (6 * f, 6 * n), None),
        "p_update": (lambda: blas1.p_update(s, r, p), lambda: blas1.p_update_plain(s, r, p),
                     (3 * f, 2 * n), lambda: torch.add(r, p, alpha=beta)),
        "dot": (lambda: blas1.dot(x, r), lambda: blas1.dot_plain(x, r), (2 * f, 2 * n),
                lambda: torch.dot(x.reshape(-1), r.reshape(-1))),
        "axpby_dot": (lambda: blas1.axpby_dot(1.0, x, -1.0, r),
                      lambda: blas1.axpby_dot_plain(1.0, x, -1.0, r), (3 * f, 5 * n), None),
    }, lab, smi)
    time_k3(torch, st5, times, x, "bf16", lab, smi)
    del y
    torch.cuda.empty_cache()
    planes = torch.rand(5, G_BIG, G_BIG, generator=gen, device=dev, dtype=bf)
    pl = f"{G_BIG}² planes bfloat16 state bfloat16"
    compare_k8(torch, st5, cmp, planes, x, (), pl)
    _time_pairs(torch, times, "bf16_bf16", {
        "spmv_stencil5": (lambda: st5.spmv_stencil5(planes, x),
                          lambda: st5.spmv_stencil5_plain(planes, x),
                          (nbytes(planes) + 2 * f, 9 * n), None)}, pl, smi)
    del planes, x, r, p
    torch.cuda.empty_cache()


def k3_pieces(st5, p, hp, hn, y, scalar=False):
    """K3 over a band with exchanged halo rows as the sharded solver's overlapped SpMV runs
    it (``cg_sharded``): the interior rows, then the first and the last row, each into
    its rows of y (``out=``), the rows next to a piece from the band itself.  Returns the
    three dots."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG, "with_dot": True, "_scalar_body": scalar}
    return [st5.spmv_stencil5_const(p[1:-1], p[0:1], p[-1:], out=y[1:-1], **kw)[1],
            st5.spmv_stencil5_const(p[0:1], hp, p[1:2], out=y[0:1], **kw)[1],
            st5.spmv_stencil5_const(p[-1:], p[-2:-1], hn, out=y[-1:], **kw)[1]]


def compare_band_pieces(torch, st5, cmp, planes, p, hp, hn, label, scalar=False):
    """K8 (``planes``) or K3 (None; its scalar body when ``scalar``, else the vector body)
    over a band with exchanged halo rows, as the sharded solver's overlapped SpMV runs it:
    the interior rows, then the first and the last row, each piece from its own
    contiguous planes into its rows of one y (``out=``), the rows next to a piece from
    the band itself.  y against the twin over the whole band (K3: bit for bit), the three
    dots' sum against its dot, and y bit for bit against the kernel's own call over the
    whole band (the synchronous SpMV)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    band = p.shape[0]
    y = torch.empty_like(p)
    if planes is None:
        before = k3_counts(st5)
        dots = k3_pieces(st5, p, hp, hn, y, scalar)
        whole, _ = st5.spmv_stencil5_const(p, hp, hn, with_dot=True, _scalar_body=scalar, **kw)
        ran = tuple(a - b for a, b in zip(k3_counts(st5), before))
        if ran != (4, 4 if scalar else 0):
            raise AssertionError(f"K3 {label}: (launches, scalar-body launches) {ran}")
        yp, dp = st5.spmv_stencil5_const_plain(p, hp, hn, with_dot=True, **kw)
        name, kind = "spmv_stencil5_const", "exact"
    else:
        def spmv(rows, above, below, out=None):
            return st5.spmv_stencil5(planes[:, rows].contiguous(), p[rows], above, below,
                                     with_dot=True, out=out)

        dots = [spmv(slice(1, band - 1), p[0:1], p[-1:], y[1:-1])[1],
                spmv(slice(0, 1), hp, p[1:2], y[0:1])[1],
                spmv(slice(band - 1, band), p[-2:-1], hn, y[-1:])[1]]
        whole, _ = spmv(slice(0, band), hp, hn)
        yp, dp = st5.spmv_stencil5_plain(planes, p, hp, hn, with_dot=True)
        name, kind = "spmv_stencil5", "field"
    cmp.check(name, label, p.dtype, [("y", y, yp, kind),
                                     ("dot", dots[0] + dots[1] + dots[2], dp, "dot"),
                                     ("y whole band", y, whole, "exact")])


# the sharded paths' fields: label -> (rows, columns, seed, key of K3's timings); the bands
# of 4 and 2 ranks and the blocks of a 2 x 2 and of a 1 x 4 mesh
SHARDED_SHAPES = {"4-rank band": (G_BIG // 4, G_BIG, 4, "band4"),
                  "2-rank band": (G_BIG // 2, G_BIG, 2, "band2"),
                  "2x2 block": (G_BIG // 2, G_BIG // 2, 22, "block2x2"),
                  "1x4 block": (G_BIG, G_BIG // 4, 14, "block1x4")}


def phase_full_size_bands(torch, st5, cmp, smi, times):
    """The sharded paths' kernels against their twins at their shapes, with exchanged halo
    rows (seeded random fields): on the bands of 2 and 4 ranks (G_BIG wide) and on the
    blocks of a 2 x 2 mesh (G_BIG/2 wide) and of a 1 x 4 mesh (G_BIG rows, G_BIG/4 wide),
    K8 in both planes dtypes and K3 (both bodies) in the overlapped SpMV's three pieces,
    in f32, f64 and bf16; K1 and K2 over a whole 4-rank band (f32, f64).  K3's three
    pieces are then timed, vector body against scalar body, into ``times`` (keys
    "<shape key>_<state>" and "<shape key>_scalar_<state>", beside the twin over the band)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        key = {torch.bfloat16: "bf16"}.get(dtype, dname(dtype).replace("float", "f"))
        for shape, (band, width, seed, skey) in SHARDED_SHAPES.items():
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(seed)

            def rand(*shape):
                return torch.rand(*shape, generator=gen, device=dev, dtype=dtype)

            p, hp, hn = rand(band, width), rand(1, width), rand(1, width)
            lab = f"{shape} {band}×{width} {dname(dtype)} + halos"
            for scalar in (False, True):
                compare_band_pieces(torch, st5, cmp, None, p, hp, hn,
                                    lab + f", three pieces, "
                                    f"{'scalar' if scalar else 'vector'} body", scalar)
            y = torch.empty_like(p)
            work = (2 * nbytes(p) + nbytes(hp, hn), 8 * p.numel())
            vector, scalar = time_k3_bodies(torch, lambda sc: k3_pieces(st5, p, hp, hn, y, sc),
                                            work, key, lab + ", three pieces", smi)
            plain = _time_ms(torch, lambda: st5.spmv_stencil5_const_plain(p, hp, hn,
                                                                          with_dot=True, **kw))
            times["spmv_stencil5_const"][f"{skey}_{key}"] = k3_entry(vector, work, key, plain)
            times["spmv_stencil5_const"][f"{skey}_scalar_{key}"] = k3_entry(scalar, work, key,
                                                                            plain)
            del y
            for pdt in dict.fromkeys((dtype, torch.bfloat16)):
                planes = rand(5, band, width).to(pdt)
                compare_band_pieces(torch, st5, cmp, planes, p, hp, hn,
                                    f"{lab}, planes {dname(pdt)}, three pieces")
                del planes
            if shape != "4-rank band" or dtype == torch.bfloat16:  # no bf16 K1, K2
                continue
            r, x = rand(band, G_BIG), rand(band, G_BIG)
            s = torch.tensor(0.37, dtype=dtype, device=dev)
            pk, dk = st5.spmv_stencil5_const_pupdate_dot(s, r, p, hp, hn,
                                                         out=torch.empty_like(p), **kw)
            pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, hp, hn, **kw)
            cmp.check("spmv_stencil5_const_pupdate_dot", f"{lab} beta=0.37", dtype,
                      [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])
            del pk, pp
            xk, rk, dk = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p, hp, hn, **kw)
            xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p, hp,
                                                             hn, **kw)
            cmp.check("cg_const_update_recompute", lab, dtype,
                      [("x'", xk, xp, "field"), ("r'", rk, rp, "field"),
                       ("<r',r'>", dk, dp, "dot")])
            del xk, rk, xp, rp, r, x
        del p
    torch.cuda.empty_cache()
    print(f"[compare] the sharded paths' bands and blocks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_full_size_generic(torch, generate, ell, dia, cmp, smi, times):
    """K11 and the ELL kernel against their twins at G_BIG² on the stencil's operands made
    on the card and a seeded random x, in f32, f64 and bf16, then timed against them; adds
    to ``times``.  The ELL kernel's library call is ``bcoo``'s matvec, cuSPARSE over the
    stencil's CSR made on the card in row bands (``ops.BCOO_BAND_ENTRIES``; at bf16 the
    f32 CSR with x widened and y rounded once), held to the kernel's y at 1e-5 (bf16:
    1e-2)."""
    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5

    dev = torch.device("cuda")
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        key = {torch.bfloat16: "bf16"}.get(dtype, dname(dtype).replace("float", "f"))
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.rand(G_BIG * G_BIG, generator=gen, device=dev, dtype=dtype)
        for name, mod, make in (("spmv_ell", ell, generate.make_stencil5_ell_device),
                                ("spmv_dia", dia, generate.make_stencil5_dia_device)):
            torch.cuda.empty_cache()
            operand = make(G_BIG, DIAG, OFFDIAG, dtype=dtype, device=dev)
            lab = f"{G_BIG}² stencil {dname(dtype)}"
            compare_generic(torch, ell, dia, cmp,
                            (operand, None) if name == "spmv_ell" else (None, operand), x, lab)
            kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
            # the operations this matrix needs: 2 per stored nonzero
            work = (nbytes(*operand, x, x), 2 * int(torch.count_nonzero(operand[0])))
            _time_pairs(torch, times, key, {name: (lambda: kern(*operand, x),
                                                   lambda: plain(*operand, x), work, None)},
                        lab, smi)
            if name == "spmv_ell":  # the twin's temporaries are gone before bcoo's CSR
                torch.cuda.empty_cache()
                bcoo = ops.get_operator("bcoo", st, dtype=dtype, device=dev)
                check_library(name, f"cuSPARSE bcoo {lab}, {len(bcoo.operand['bands'])} row "
                              f"bands of at most {ops.BCOO_BAND_ENTRIES} entries",
                              bcoo.run_device(x), kern(*operand, x),
                              tol=BF16_TOL if dtype == torch.bfloat16 else 1e-5)
                e = times[name][key]
                _time_library(torch, e, lambda: kern(*operand, x), lambda: bcoo.run_device(x))
                print(f"[time] {KERNELS[name][0]} {name} {lab}: kernel {e['ms']!r} ms, library "
                      f"(cuSPARSE bcoo) {e['library_ms']!r} ms [{smi}]", flush=True)
                bcoo.free()
                del bcoo
            del operand
            if name == "spmv_ell":
                time_ell_band(torch, ell, generate, cmp, times[name][key], dtype, smi)
        del x
    torch.cuda.empty_cache()


def time_ell_band(torch, ell, generate, cmp, square, dtype, smi):
    """The ELL kernel's rectangular call as the sharded csr band makes it on 4 ranks
    (G_BIG/4 grid rows over their gather domain, the band's own dot from ``dot_offset``):
    against its twin (y bit for bit, the dot to tolerance), then timed beside the square
    call's rate at G_BIG² (``square``: its timing entry), both in GB/s of the bytes each
    must move."""
    torch.cuda.empty_cache()
    rows = G_BIG // 4
    vals, cols = ell_band(torch, generate, G_BIG, rows, 2 * rows, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dom = torch.rand((rows + 2) * G_BIG, generator=gen, device="cuda", dtype=dtype)

    def call():
        return ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=G_BIG)

    y, d = call()
    yp, dp = ell.spmv_ell_plain(vals, cols, dom, with_dot=True, dot_offset=G_BIG)
    cmp.check("spmv_ell", f"{rows} of {G_BIG} rows over their gather domain "
              f"{dname(dtype)}", dtype, [("y", y, yp, "exact"), ("dot", d, dp, "dot")])
    del y, yp
    ms = _time_ms(torch, call)
    moved = nbytes(vals, cols, dom) + rows * G_BIG * dom.element_size()
    square_gbs = square["bound_ms"] * HBM_BYTES_PER_S / 1e9 / square["ms"]
    print(f"[time] ELL kernel rectangular, {rows} of {G_BIG} rows over their gather domain, "
          f"{dname(dtype)}: {ms!r} ms, {moved / ms / 1e6!r} GB/s; the square call at "
          f"{G_BIG}²: {square['ms']!r} ms, {square_gbs!r} GB/s [{smi}]", flush=True)
    del vals, cols, dom


def phase_profile(torch, smi, medians):
    """Where a solve's time goes: one solve of each CG run and each fused solve of phase 5
    under torch.profiler at G_BIG² (after two unprofiled ones), its device time split by
    kernel.  "idle" is the solve's unprofiled median from phase 5 (``medians``: label ->
    ms) minus the summed device time of the profiled solve's kernels, memsets and copies:
    a difference, not a timeline.  The profiled solve's own wall time is printed beside it
    only as an aside, since it also holds the profiler's cost of recording the phase
    ranges.  The full tables go to chiprun_out/profile.txt.  The solver's phase scopes
    (``bench.profiling``) are ranges, not device work, and stay out of the sums.  Returns
    {label: {kernel group: device ms}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5
    from tpusparse_torch.solvers import cg

    groups = [(short, re.compile(rf"(?<![a-z_]){fn}")) for short, fn, _s, _r in
              KERNELS.values()]
    groups.append(("final sums", re.compile(r"(?<![a-z_])final_sum_kernel")))
    groups.append(("cuSPARSE", re.compile(r"cusparse|csrmv", re.IGNORECASE)))
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    tables, splits = [], {}
    dtypes = {"--dtype=f64": torch.float64, "--dtype=bf16": torch.bfloat16}
    solves = [(label, mode, next((dt for a, dt in dtypes.items() if a in extra), torch.float32),
               {"recompute_ap": False if "--loop=classic" in extra else None})
              for label, (mode, extra, _iters, _needs) in CG_RUNS.items()
              if label not in BF16_RUNS[1:]]  # one bf16 solve: stencil5's
    solves += [(label, mode, getattr(torch, dtype_name), {"fused_pupdate": True})
               for label, (mode, dtype_name, _iters, _pass) in FUSED_RUNS.items()]
    for label, mode, dtype, kwargs in solves:
        op = ops.get_operator(mode, st, dtype=dtype, device="cuda")
        for _ in range(2):
            cg.cg_solve(op, b_is_ones=True, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            x, stats = cg.cg_solve(op, b_is_ones=True, **kwargs)
            wall = (time.perf_counter() - t0) * 1e3
        del x
        # the solver's phase scopes appear as device rows too (their ranges on the card's
        # timeline): leave them out, or their kernels would count twice
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.key not in PHASE_NAMES]
        if not rows:
            raise AssertionError(f"profile {label}: the profiler saw no device time")
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        split = {}
        for e in rows:
            g = next((g for g, pat in groups if pat.search(e.key)), "other device")
            split[g] = split.get(g, 0.0) + e.self_device_time_total / 1e3
        splits[label] = split
        median = medians[label]
        parts = ", ".join(f"{g} {ms!r} ms ({100 * ms / median:.1f}%)"
                          for g, ms in split.items())
        print(f"[profile] {label} {G_BIG}², {stats.iterations} iterations: phase 5's median "
              f"{median!r} ms, device busy {busy!r} ms; {parts}; idle (median - busy) "
              f"{median - busy!r} ms ({100 * (median - busy) / median:.1f}%); the profiled "
              f"solve's wall {wall!r} ms [{smi}]", flush=True)
        tables.append(f"=== {label}: wall {wall!r} ms\n"
                      + prof.key_averages().table(sort_by="self_device_time_total",
                                                  row_limit=16, max_name_column_width=70))
        op.free()
        del op
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "profile.txt").write_text("\n\n".join(tables))
    return splits


def check_trace(smi):
    """The --trace run's Chrome trace: it must hold the phase ranges and K8's, K4's and
    K5's kernels.  Prints the ranges' summed wall time beside the summed device time of
    the kernels inside them (the traced solve is the host-stepped one)."""
    traces = sorted(TRACE_DIR.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"--trace wrote {len(traces)} trace files into {TRACE_DIR}")
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("ph") == "X"]
    names = {e.get("name", "") for e in events}
    missing = [n for n in PHASE_NAMES if n not in names]
    missing += [KERNELS[w][0] for w in ("spmv_stencil5", "cg_update", "p_update")
                if not any(re.search(KERNELS[w][1], n) for n in names)]
    print(f"[trace] {traces[0].name}: {len(events)} events, {traces[0].stat().st_size} "
          f"bytes; missing {missing or 'nothing'}", flush=True)
    if missing:
        raise AssertionError(f"the trace lacks {missing}")
    ranges = {n: sum(e["dur"] for e in events if e["name"] == n and e.get("cat") ==
                     "user_annotation") / 1e3 for n in PHASE_NAMES}
    groups = [(short, re.compile(rf"(?<![a-z_]){fn}")) for short, fn, _s, _r in
              KERNELS.values()] + [("final sums", re.compile(r"final_sum_kernel"))]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            g = next((g for g, pat in groups if pat.search(e["name"])), "other kernels")
            kernels[g] = kernels.get(g, 0.0) + e["dur"] / 1e3
    print("[trace] ranges (host wall): " + ", ".join(f"{n} {ms!r} ms" for n, ms in
                                                     ranges.items())
          + "; kernels (device): " + ", ".join(f"{g} {ms!r} ms" for g, ms in kernels.items())
          + f" [{smi}]", flush=True)


def compare_stream_probes(torch):
    """The streaming probe kernels against their twins on the probe's own field (2^30 f32,
    seeded): the read's partials sum to the field's sum (1e-5 relative to the sum of
    magnitudes: f32 partials in another order), the copy equals its source bit for bit.
    Their launches here are not counted: the counts are reset before each path."""
    from tpusparse_torch.kernels import stream_probe

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(2 ** 30, generator=gen, device="cuda")
    part = torch.empty(stream_probe.read_partials(x), device="cuda")
    got = stream_probe.read(x, part).double().sum()
    want = stream_probe.read_plain(x.double(), torch.empty(1, dtype=torch.float64,
                                                            device="cuda"))[0]
    err = float((got - want).abs() / x.double().abs().sum())
    dst = torch.empty_like(x)
    exact = torch.equal(stream_probe.copy(x, dst), stream_probe.copy_plain(x, x.clone()))
    print(f"[compare] probe_read 2^30 f32: sum rel err {err:.3e} (tol 1e-5); probe_copy: "
          f"{'bit for bit' if exact else 'DIFFERS'}", flush=True)
    if not (err <= 1e-5 and exact):
        raise AssertionError(f"the streaming probe kernels disagree with their twins: read "
                             f"{err:.3e}, copy exact {exact}")
    del x, dst


def print_ceiling_shares(times, achievable_gbs, smi):
    """Each kernel's streaming rate at G_BIG² (phase 6: its bytes over its time) as a share
    of the data sheet and of the measured ceiling; a share above 100% marks a ceiling
    that is no ceiling."""
    parts, over = [], []
    for name, (short_name, _fn, _src, _rep) in KERNELS.items():
        for key, e in times[name].items():
            if e["bound_by"] != "bytes":
                continue
            gbs = e["bound_ms"] / e["ms"] * HBM_BYTES_PER_S / 1e9
            share = 100 * gbs / achievable_gbs
            parts.append(f"{short_name} {key} {gbs:.1f} GB/s = "
                         f"{100 * e['bound_ms'] / e['ms']:.1f}% / {share:.1f}%")
            if share > 100:
                over.append(f"{short_name} {key}")
    print(f"[ceiling] kernels at {G_BIG}² (share of the data sheet / of the measured "
          f"{achievable_gbs!r} GB/s): " + ", ".join(parts)
          + f"; above the measured ceiling: {over or 'none'} [{smi}]", flush=True)


def phase_stepped(torch, counters, cg_cli, spmv_cli, results, splits, times, smi):
    """Phase 8: the CG CLI's host-stepped loop and its other flags at G_BIG², each run from
    its own launch counts, then the probes of the card's streaming ceiling.  ``splits``:
    phase 7's device time by kernel group, per solve; ``times``: phase 6's kernel times."""
    import shutil

    from tpusparse_torch.bench import probes, profiling

    t_phase = time.perf_counter()
    counts = PathCounts(counters)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    ref = results["stencil5 f64"]["validation"]
    for label, (extra, loop, iters, needs) in STEPPED_RUNS.items():
        path = OUT / f"chip_smoke_cg_{re.sub(r'[^a-z0-9]+', '_', label)}.json"
        rc = counts.run(f"cg {label}", needs, lambda: cg_cli.main(
            [f"gen:{G_BIG}", *extra, f"--json={path}"]))
        res = json.loads(path.read_text())
        its, t = res["convergence"]["iterations"], res["timing"]
        print(f"[stepped] {label}: rc {rc}, mode {res['mode']}, loop {res['loop']}, "
              f"{its} iterations, median {t['total_median_ms']!r} ms over "
              f"{res['statistics']['total_runs']} runs; spmv {t['spmv_ms']!r} ms, blas1 "
              f"{t['blas1_ms']!r} ms, reductions {t['reductions_ms']!r} ms [{smi}]",
              flush=True)
        if rc != 0 or not res["convergence"]["converged"] or res["loop"] != loop:
            raise AssertionError(f"{label}: rc {rc}, loop {res['loop']} (want {loop})")
        mode = "stencil5-const" if "--mode=stencil5-const" in extra else "stencil5"
        if res["mode"] != mode:  # the --device run names no mode: the default's
            raise AssertionError(f"{label}: mode {res['mode']}, not {mode}")
        if iters is not None and its != iters:
            raise AssertionError(f"{label}: {its} iterations, not {iters}")
        buckets = (t["spmv_ms"], t["blas1_ms"], t["reductions_ms"])
        if loop == "host-stepped" and not (min(buckets) > 0
                                          and sum(buckets) <= t["total_median_ms"]):
            raise AssertionError(f"{label}: buckets {buckets} against the median "
                                 f"{t['total_median_ms']} ms")
        if "--dtype=f64" in extra:
            v = res["validation"]
            errs = {k: abs(v[k] - ref[k]) / abs(ref[k]) for k in ("solution_sum",
                                                                  "solution_norm")}
            print(f"[stepped] {label} against phase 5's stencil5 f64: Sum rel "
                  f"{errs['solution_sum']:.3e}, Norm2 rel {errs['solution_norm']:.3e} "
                  f"(tol 1e-10)", flush=True)
            if not max(errs.values()) <= 1e-10:
                raise AssertionError(f"{label} differs from stencil5 f64: {errs}")
        if label == "stepped stencil5 f64":
            prof = splits["stencil5 f64"]
            print(f"[stepped] buckets of the stepped stencil5 f64 solve beside phase 7's split "
                  f"of one classic solve: spmv {t['spmv_ms']!r} ms (K8 {prof['K8']!r} + final "
                  f"sums {prof['final sums']!r} ms), blas1 {t['blas1_ms']!r} ms (K4 "
                  f"{prof['K4']!r} + K5 {prof['K5']!r} = {prof['K4'] + prof['K5']!r} ms), "
                  f"reductions {t['reductions_ms']!r} ms (no counterpart); sum "
                  f"{sum(buckets)!r} of {t['total_median_ms']!r} ms [{smi}]", flush=True)
    check_trace(smi)
    for label, recorded in RECORDED_MEDIANS.items():
        print(f"[solve] phase 5's {label} median {results[label]['timing']['total_median_ms']!r}"
              f" ms (recorded before the phase scopes: {recorded} ms) [{smi}]", flush=True)
    # the host cost of the phase scopes the loops now enter (2 or 3 an iteration)
    t0 = time.perf_counter()
    for _ in range(SCOPE_PAIRS):
        with profiling.scope(profiling.PHASE_SPMV):
            pass
    us = (time.perf_counter() - t0) / SCOPE_PAIRS * 1e6
    print(f"[scope] one phase scope (an NVTX range; no profiler runs) costs {us!r} µs on the "
          f"host; 42 of them, a 14-iteration classic solve's, {42 * us / 1e3!r} ms [{smi}]",
          flush=True)

    torch.cuda.empty_cache()
    compare_stream_probes(torch)
    path = OUT / "chip_smoke_spmv_probe.json"
    rc = counts.run("spmv stencil5 --ceiling-probe", SPMV_NEEDS["stencil5"] + PROBE_KERNELS,
                    lambda: spmv_cli.main(
                        [f"gen:{G_BIG}", "--mode=stencil5", "--ceiling-probe", "--resident-x",
                         "--runs=3", "--warmup=1", f"--json={path}"]))
    res = json.loads(path.with_name(f"{path.stem}_stencil5.json").read_text())
    probe, perf = res["ceiling_probe"], res["benchmark"]["performance"]
    print("[probe] " + ", ".join(f"{n} {probe[f'{n}_gbs']!r} GB/s" for n in probe["probes"])
          + f"; achievable {probe['achievable_gbs']!r} GB/s, over the data-sheet peak "
          f"{probe['probes_over_peak']}; stencil5 SpMV {perf['bandwidth_gbs']!r} GB/s = "
          f"{perf['roofline_fraction_achievable']!r} of it ({perf['roofline_fraction']!r} of "
          f"the data sheet) [{smi}]", flush=True)
    if rc != 0 or not perf.get("roofline_fraction_achievable"):
        raise AssertionError(f"spmv_bench --ceiling-probe: rc {rc}, {perf}")
    print_ceiling_shares(times, probe["achievable_gbs"], smi)
    torch.cuda.empty_cache()
    if probes.main([f"--out={OUT}"]) != 0:
        raise AssertionError("python -m tpusparse_torch.bench.probes failed")
    again = json.loads((OUT / "probe_ceiling.json").read_text())
    print("[probe] again: " + ", ".join(f"{n} {again[f'{n}_gbs']!r} GB/s"
                                         for n in again["probes"])
          + f"; achievable {again['achievable_gbs']!r} GB/s [{smi}]", flush=True)
    for pt in json.loads((OUT / "probe_onchip_knee.json").read_text())["points"]:
        print(f"[knee] {pt['footprint_mib']} MiB: copy chain {pt['copy_chain_gbs']!r} GB/s, "
              f"{pt['per_pass_us']!r} µs per pass, k {pt['k_lo']}/{pt['k_hi']} [{smi}]",
              flush=True)
    (OUT / "chip_smoke_launches_stepped.json").write_text(json.dumps(counts.by_path, indent=1))
    print(f"[stepped] phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _sharded_rank(device, argv, counts_path):
    """One rank of a phase-9 run (spawned by dist.launch_local): the multichip CLI's main()
    in the group, as under torchrun, its launch counts and the solver's halo counts
    (``cg_sharded.HALO_CALLS``: the exchanges, and the calls given an exchanged row) set
    to 0 just before and written to <counts_path>_rank<r>.json just after."""
    from tpusparse_torch import dist
    from tpusparse_torch.cli import cg_solver_multichip
    from tpusparse_torch.kernels import blas1, ell
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg_sharded

    counters = (st5, blas1, ell)
    for c in counters:
        c.reset_launches()
    cg_sharded.reset_halo_calls()
    rc = cg_solver_multichip.main(argv)
    counts = {"LAUNCHES": {n: v for c in counters for n, v in c.LAUNCHES.items() if v},
              "HALO_CALLS": dict(cg_sharded.HALO_CALLS)}
    pathlib.Path(f"{counts_path}_rank{dist.rank()}.json").write_text(json.dumps(counts))
    return rc


def _bf16c_rank(device):
    """stencil5 and stencil5-bf16c, f32, at G_BIG² on this rank; rank 0 returns whether
    the gathered solutions are equal bit for bit, and both iteration counts."""
    import numpy as np
    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    xs, its = [], []
    for mode in ("stencil5", "stencil5-bf16c"):
        x, s = cg_sharded.cg_solve_sharded(G_BIG, mode=mode, dtype=torch.float32,
                                           device=device)
        xs.append(dist.gather_to_host(x, rows=G_BIG))
        its.append(s.iterations)
        del x
        cg_sharded.clear_caches()
    return None if xs[0] is None else (bool(np.array_equal(xs[0], xs[1])), its)


def _band_halo_missing(n, r, counts, halo_needs):
    """What a rank of a row-band run lacks: on several ranks every rank has a neighbour,
    and each exchange's rows must reach a launch of each of its path's halo kernels; one
    rank exchanges nothing."""
    halo = counts["HALO_CALLS"]
    if n == 1:
        return [f"no halo on one rank, got {halo}"] if any(halo.values()) else []
    return [f"{short(k)} on exchanged halo rows ({halo[k]} of {halo['exchange']} exchanges)"
            for k in halo_needs
            if not 0 < halo["exchange"] <= halo[k] <= counts["LAUNCHES"].get(k, 0)]


def _block_halo_missing(mesh, r, counts, halo_kernel):
    """What a rank of a 2-D run lacks: with a N/S neighbour, row exchanges whose rows reach
    its SpMV kernel's launches; with a W/E neighbour, column exchanges each consumed by one
    or two side-column corrections; with neither (a 1 x 1 mesh), no exchange."""
    halo, nr, nc = counts["HALO_CALLS"], mesh[0], mesh[1]
    i, j = divmod(r, nc)
    rows, cols = (i > 0) + (i < nr - 1), (j > 0) + (j < nc - 1)
    missing = []
    if rows and not 0 < halo["exchange"] <= halo[halo_kernel] \
            <= counts["LAUNCHES"].get(halo_kernel, 0):
        missing.append(f"{short(halo_kernel)} on exchanged halo rows ({halo[halo_kernel]} of "
                       f"{halo['exchange']} exchanges)")
    if cols and not 0 < halo["column_exchange"] * cols == halo["column_correction"]:
        missing.append(f"{cols} corrections an exchange with exchanged columns "
                       f"({halo['column_correction']} of {halo['column_exchange']} exchanges)")
    if not rows and halo["exchange"] or not cols and halo["column_exchange"]:
        missing.append(f"no exchange without a neighbour, got {halo}")
    return missing


def run_multichip(label, n, argv, loop, ref_label, needs, halo_missing, results, smi,
                  launches):
    """One multichip CLI run on n ranks sharing the card, from its ranks' own launch
    counts: every rank must launch ``needs``, ``halo_missing(r, counts)`` says what rank r
    lacks on its exchanged halos, the solution must equal phase 5's ``ref_label`` to
    1e-10 in 14 iterations (a bf16 state's: to BF16_TOL, in any count), and a
    host-stepped run's four buckets must be > 0 and sum to no more than its median.  Adds the ranks' launches to ``launches``; returns the
    export."""
    from tpusparse_torch import dist

    slug = re.sub(r"[^a-z0-9]+", "_", label)
    path, counts_path = OUT / f"chip_smoke_{slug}.json", SHARDED_DIR / slug
    bf16 = "--dtype=bf16" in argv  # any iteration count, x within BF16_TOL
    tol = BF16_TOL if bf16 else 1e-10
    t0 = time.perf_counter()
    rc = dist.launch_local(_sharded_rank, n, [f"gen:{G_BIG}", *argv, *SHARDED_ARGS,
                                              f"--json={path}"],
                           str(counts_path), device="cuda")
    wall = time.perf_counter() - t0
    res = json.loads(path.read_text())
    its, t = res["convergence"]["iterations"], res["timing"]
    for r in range(n):
        counts = json.loads(pathlib.Path(f"{counts_path}_rank{r}.json").read_text())
        halo = counts["HALO_CALLS"]
        print(f"[launches] {label} rank {r}: " + ", ".join(
            f"{short(k)} {v} ({halo.get(k, 0)} on exchanged halo rows)"
            for k, v in counts["LAUNCHES"].items())
            + f"; {halo['exchange']} row exchanges, {halo['column_exchange']} column "
              f"exchanges, {halo['column_correction']} corrections with exchanged columns",
            flush=True)
        missing = [short(k) for k in needs if not counts["LAUNCHES"].get(k)]
        missing += halo_missing(r, counts)
        if missing:
            raise AssertionError(f"{label} rank {r}: never launched {missing}")
        k3_scalar_launched(f"{label} rank {r}", counts["LAUNCHES"])
        for k, v in counts["LAUNCHES"].items():
            launches[k] = launches.get(k, 0) + v
    ref = results[ref_label]["validation"]
    errs = {k: abs(res["validation"][k] - ref[k]) / abs(ref[k])
            for k in ("solution_sum", "solution_norm")}
    rank_t = (f"rank times max {t['solve_time_max_ms']!r} / min {t['solve_time_min_ms']!r}"
              f" ms, imbalance {t['load_imbalance_pct']!r}%" if n > 1 else "one rank")
    print(f"[sharded] {label}: rc {rc}, solver {res['solver']}, mode {res['mode']}, loop "
          f"{res['loop']}, {its} iterations, median {t['total_median_ms']!r} ms over "
          f"{res['statistics']['total_runs']} runs ({rank_t}); gather to rank 0 "
          f"{t['allgather_ms']!r} ms; Sum rel {errs['solution_sum']:.3e}, Norm2 rel "
          f"{errs['solution_norm']:.3e} against phase 5's {ref_label} (tol {tol:g}); the "
          f"run's wall {wall:.1f} s [{smi}]", flush=True)
    if rc != 0 or (its != 14 and not bf16) or res["loop"] != loop \
            or not max(errs.values()) <= tol:
        raise AssertionError(f"{label}: rc {rc}, {its} iterations, loop {res['loop']}, "
                             f"{errs}")
    if loop == "host-stepped":
        buckets = {k: t[f"{k}_ms"] for k in ("halo", "spmv", "allreduce", "blas1")}
        print(f"[sharded] {label} buckets: " + ", ".join(
            f"{k} {v!r} ms" for k, v in buckets.items())
              + f"; sum {sum(buckets.values())!r} of the median {t['total_median_ms']!r} "
              f"ms [{smi}]", flush=True)
        if not (min(buckets.values()) > 0 and sum(buckets.values()) <= t["total_median_ms"]):
            raise AssertionError(f"{label}: buckets {buckets}")
    return res


def phase_sharded(torch, results, smi):
    """Phase 9: the multichip CLI at G_BIG² with 1, 2 and 4 ranks sharing the card (gloo,
    halos and dots staged through the host), each run from its ranks' own launch counts.
    Returns {wrapper: launches summed over the runs and ranks}."""
    from tpusparse_torch import dist

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    SHARDED_DIR.mkdir(parents=True, exist_ok=True)
    launches = {}
    for label, (n, extra, loop, ref_label, needs, halo_needs) in SHARDED_RUNS.items():
        res = run_multichip(
            label, n, [*extra, f"--chips={n}"], loop, ref_label, needs,
            lambda r, counts, n=n, halo_needs=halo_needs: _band_halo_missing(
                n, r, counts, halo_needs), results, smi, launches)
        if n == 1:
            single = results[ref_label]["timing"]["total_median_ms"]
            median = res["timing"]["total_median_ms"]
            print(f"[sharded] {label}: one rank's median {median!r} ms against "
                  f"phase 5's single-device {ref_label} median {single!r} ms: the sharded "
                  f"machinery and its host-read dots cost {median - single!r} ms a solve "
                  f"[{smi}]", flush=True)
    t0 = time.perf_counter()
    equal, its = dist.launch_local(_bf16c_rank, 2, device="cuda")
    print(f"[sharded] stencil5-bf16c f32 on 2 ranks: {its[1]} iterations, x equal to "
          f"stencil5 f32's ({its[0]} iterations) bit for bit: {equal} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not equal or its[0] != its[1]:
        raise AssertionError("sharded stencil5-bf16c x differs from sharded stencil5 f32 x")
    print(f"[sharded] phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_mesh2d(torch, results, smi):
    """Phase 10: the multichip CLI's 2-D block decomposition (--mesh2d) at G_BIG² f64, its
    ranks sharing the card, each run from its ranks' own launch counts; each median beside
    phase 9's 4-rank row-band median of the same mode.  Returns {wrapper: launches summed
    over the runs and ranks}."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    for label, (mesh, extra, loop, ref_label, needs, band_label) in MESH2D_RUNS.items():
        halo_kernel = needs[0]
        res = run_multichip(
            label, mesh[0] * mesh[1], [*extra, f"--mesh2d={mesh[0]}x{mesh[1]}"], loop,
            ref_label, needs,
            lambda r, counts, mesh=mesh, k=halo_kernel: _block_halo_missing(mesh, r, counts,
                                                                            k),
            results, smi, launches)
        if res["solver"] != f"tpusparse-cg-sharded2d-{mesh[0]}x{mesh[1]}":
            raise AssertionError(f"{label}: solver {res['solver']}")
        band = OUT / f"chip_smoke_{re.sub(r'[^a-z0-9]+', '_', band_label)}.json"
        band_ms = json.loads(band.read_text())["timing"]["total_median_ms"]
        print(f"[mesh2d] {label}: median {res['timing']['total_median_ms']!r} ms against "
              f"phase 9's {band_label} {band_ms!r} ms [{smi}]", flush=True)
    print(f"[mesh2d] phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from tpusparse_torch import _build, generate, native
    from tpusparse_torch.bench import sysinfo
    from tpusparse_torch.cli import cg_solver as cg_cli
    from tpusparse_torch.cli import spmv_bench as spmv_cli
    from tpusparse_torch.kernels import blas1, dia, ell, stream_probe
    from tpusparse_torch.kernels import stencil5 as st5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card(torch, sysinfo)
    phase_build(_build)
    print(f"[build] host Matrix Market library (g++): "
          f"{'in use' if native.available() else 'absent, the numpy readers run'}", flush=True)
    cmp = Compare(torch)
    phase_compare(torch, st5, blas1, ell, dia, cmp)
    phase_checksum(torch, st5, ell, dia, generate)
    results, fused, launches = phase_main_path(torch, (st5, blas1, ell, dia), cg_cli,
                                               spmv_cli)
    times = phase_full_size(torch, st5, blas1, cmp, smi)
    phase_full_size_bf16(torch, st5, blas1, cmp, smi, times)
    phase_full_size_bands(torch, st5, cmp, smi, times)
    phase_full_size_generic(torch, generate, ell, dia, cmp, smi, times)
    medians = {label: res["timing"]["total_median_ms"] for label, res in results.items()}
    medians.update({label: median_ms for label, (median_ms, _its) in fused.items()})
    splits = phase_profile(torch, smi, medians)
    phase_stepped(torch, (st5, blas1, ell, dia, stream_probe), cg_cli, spmv_cli, results,
                  splits, times, smi)
    for name, count in phase_sharded(torch, results, smi).items():
        launches[name] += count
    for name, count in phase_mesh2d(torch, results, smi).items():
        launches[name] += count
    for label, res in results.items():
        print(f"[solve] {label} {G_BIG}²: median {res['timing']['total_median_ms']!r} ms, "
              f"{res['convergence']['iterations']} iterations, "
              f"{res['statistics']['valid_runs']}/{res['statistics']['total_runs']} valid "
              f"runs [{smi}]")
    for label, (median_ms, iterations) in fused.items():
        print(f"[solve] {label} {G_BIG}²: median {median_ms!r} ms, {iterations} iterations, "
              f"{FUSED_TIMED} timed runs [{smi}]")
    imported = sorted(m for m in sys.modules if m in ("jax", "tpusparse")
                      or m.startswith(("jax.", "tpusparse.")))
    if imported:
        raise AssertionError(f"the port imported {imported}")

    record = {"kernels": []}
    for name, (short, _fn, source, replaces) in KERNELS.items():
        t = times[name]
        entry = {"name": name, "short": short, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": cmp.max_abs[name], "max_rel_err": cmp.max_rel[name],
                 **t["f32"]}
        if name == "spmv_stencil5_const":
            entry["launches_scalar_body"] = launches[K3_SCALAR]
        for key, e in t.items():
            if key != "f32":
                entry.update({f"{k}_{key}": v for k, v in e.items() if k != "bound_by"})
        record["kernels"].append(entry)
    print(f"nvidia-smi: {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)

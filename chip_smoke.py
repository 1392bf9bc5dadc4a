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
     phase 8, the measured ceiling); K1's and K2's two bodies the same way at 20480² and
     at the benchmark's 20000², f32 and f64, after holding both to the twin (p', x' and
     r' bit for bit).  The bf16-state instances the same way (fields bit
     for bit): K3, K4-K7 and K8 (bf16 planes) at 20480², against F.conv2d in bf16,
     torch.add and torch.dot on bf16 (held to the kernel at 1e-2: the library rounds once
     where the kernel rounds each operation), K11 and the ELL kernel (against bcoo at
     bf16), the rectangular ELL call, and K3 and K8 in the band and block pieces.  Each
     kernel's bound: the bytes its call must move (inputs read once, outputs written
     once) over 3.35 TB/s, or its operations over the data sheet's peak rate, whichever is
     larger (a bf16 state computes in f32);
     the solves' median times, next to the card's name and power limit;
  7. one solve of each CG run of phase 5 (bcoo f64 included; of the bf16 runs, stencil5
     only), and of each fused solve, under torch.profiler, its device time split by
     kernel (the graph loop's replayed kernels, its condition kernel among them), and its
     idle time: phase 5's unprofiled median less the profiled device time (PERF.md
     section 5);
 11. (run after phase 7) the CG graph loop, cg_solve's default on a card, against the
     eager loop (graph=False) at gen:20480 in every single-device loop, mode and dtype it
     runs (GRAPH_RUNS: stencil5-const f64/f32 recompute, f32 and bf16 classic; stencil5
     f64/f32/bf16; stencil5-bf16c f32; csr and dia f64; the fused loop on stencil5 and
     stencil5-const, f64): the same iterations (14 in f64) and x bit for bit, the graph
     loop reading the card once a solve (one replay) and the eager loop once an
     iteration and twice more; their medians over GRAPH_ROUNDS rounds of eager, graph,
     graph, eager solves (chiprun_out/chip_smoke_graph.json);
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
     and the rank-time max/min/imbalance;
 12. the port's scripts (tpusparse_torch.scripts), each through its main(argv) and read
     from its own launch counts, writing into chiprun_out/scripts: detect_config (every
     mode's largest grid), then one stencil5-const f32 recompute solve at the largest grid
     it names (past 2^31 elements a field; capture, then replay), each taking exactly the
     iterations of CG in exact arithmetic at that grid (exact_cg_iterations, from the
     stencil's spectrum), its true relative residual (A·x by K3, the norm summed in f64)
     at most 1e-5, K3 bit for bit its twin on the band holding element 2^31 and the last
     band, its time and peak memory as a share of the card's; audit_cg_iteration at
     1024² and G_BIG² (each phase launching its kernel exactly as its chains say, both
     loops converging in the exact count, their closure printed, and within 80-120% at
     G_BIG²); profile_kernel gen:4096 on stencil5 and
     stencil5-const, PROFILE_REPS applies a mode (each trace naming its kernel); run_all
     --size=4096; sweep spmv at
     its defaults; sharded_compare --grid 1024 --devices 2; then the SpMV exports of the
     sweep, run_all and phase 5 under the format table's names (spmv_<g>_h100_<mode>.json)
     with run_all's CG exports and phase 8's probe, and format_table over them (its CSV and
     document; a cell for every mode of TABLE_MODES at 4096² and G_BIG²).
 13. (run after phase 12) the top-level entry points, each from its own launch counts: the
     headline benchmark (python -m tpusparse_torch.bench.headline's main) for --metric=cg
     and --metric=spmv, each alone in a fresh process (this script with HEADLINE_CHILD,
     which writes the process's launch counts to chiprun_out/headline/), exactly one JSON
     line each: the CG line with bench.py's keys and device, 14 iterations, at least 8
     valid runs, the faster loop named and its median within 10% of phase 5's CLI median
     of the same solve; the SpMV line's share of the HBM peak at most 1.05;
     K8 held to its twin on the SpMV line's own inputs (10240², f32, x from seed 0);
     tpusparse_torch.entry.entry()'s forward (K8 with its dot at 256², f32) held to the
     plain twin on its x = ones and on a random x; tpusparse_torch.entry.dryrun_multichip
     on meshes of 2 and 4 shards sharing the card (f64, exact parity with the
     single-device solve), launching K8 on exchanged halo rows, K4, K5 and K6, and those
     kernels held to their twins in f64 at the dryrun's shapes: each shard's band or block
     with halo rows (K8 also in the overlapped SpMV's three pieces) and the one-device
     grids.
 14. (run after phase 13) the sharded CG over a mesh of shards that one process drives
     (the multichip CLI without a process group: cg_sharded.MeshOperator, halos copied on
     the card, the dots summed on it in shard order, the loop one CUDA graph replay a
     solve), every shard on the card, at gen:20480 uncut, each run from its own launch
     counts: stencil5 f64 on 2 and 4 shards, stencil5-const f32 recompute on 2 and 4 (the
     headline's problem) and f64 on 4, csr f64 on 2 and 4, --mesh2d=2x2 stencil5 f64 and
     const f64 classic, stencil5 bf16 on 2 shards and 2x2, and --timers stencil5 f64 on 4:
     14 iterations (bf16: any), Sum/Norm2 against phase 5's single-device solve (f64
     1e-10, f32 1e-5, bf16 1e-2 against stencil5 f64) and bit for bit against the phase
     9/10 gloo run of the same decomposition where there is one, every shard on
     cuda:0, one replay and one read a solve (none in the stepped loop), and exactly the
     launches and halo counts its iterations make (the graph's replays counted through
     _launch.count_replay); each median beside the single-device and the gloo medians;
     four of its solves profiled beside phase 7's single-device split of the same solve
     (chiprun_out/profile_mesh.txt); the mesh's x bit for bit the gloo ranks' at 2048² in
     eleven cases (2 and 4 ranks
     sharing the card); a halo exchange and an ordered sum each timed in a CUDA graph on
     2 and 4 bands and a 2 x 2 mesh; K4-K7 at the 2- and 4-shard band and the 2 x 2 block
     shapes (f32, f64, bf16), K6 on a side column, K1 and K2 on the 2-shard band and the
     ELL kernel's rectangular call over its gather domain, against their twins
     (chiprun_out/chip_smoke_mesh.json).
 15. (run after phase 14) the per-card loop (cg_sharded.CardLoop, per_shard=True): one CUDA
     graph a card, replayed on its stream, its shards in lockstep in it, the shards meeting
     through csrc/mesh_sync.cu's kernels (rows and dot partials stored into the other
     shards' buffers, each shard waiting for them and adding the partials in shard order
     itself), its shards sharing the card, at 20480² against the mesh's one graph:
     stencil5 f64 on 2 and 4 shards, const f32 recompute and csr f64 on 4, stencil5 bf16
     on 2, 2 x 2 stencil5 f64; a first solve of each loop, then three rounds in turns
     (medians of 3); the per-card solves are the path, read from their own counts: x bit
     for bit the mesh's, 14 iterations (bf16: the mesh's), one read and one replay a card
     a solve, exactly the launches its iterations make (the sync kernels' among them); the
     sync kernels against their twins bit for bit (2 and 4 shards, f64, f32 and bf16 rows,
     a strided column, both waits, a wait past its bound), each timed in a CUDA graph of
     50; the withheld-shard child (chip_smoke.py --withheld-child <bound>: shard 1 of 2
     left out of the card's graph, shard 0's waits must give up within the bound and the
     solve raise, and a new loop then solve); and the profiled child (chip_smoke.py
     --profiled-child, under a time limit: a torch.profiler session begun before the
     kernels load, then the per-card loop on 4 shards sharing the card at 2048² f64, x bit
     for bit the mesh's) (chiprun_out/chip_smoke_cards.json).
 16. (run after phase 15) ranks that each drive a mesh of local shards
     (dist.make_rank_mesh): dist.launch_local with 2 gloo ranks sharing the card (so the
     transport between them is gloo: NCCL refuses two ranks on one card), each driving 2
     of the 4 shards of one mesh on cuda:0 (halos copied on the card within a rank, the
     rows and columns whose neighbour is on the other rank and every dot through the host
     by gloo, the partials added in global shard order), at 20480²: 4 bands in stencil5
     f64 and const f32 recompute, the 2-D blocks of a 2 x 2 mesh (rows cross the ranks)
     and of a 1 x 4 mesh (a column crosses) in stencil5 f64, and one --timers run (the
     stepped loop) of the 4 bands: a first solve, then three timed ones (a solve's time
     the slowest rank's), each rank's launches and halo counts set to 0 before and read
     after (a row exchange an iteration for each of its shards with a N/S neighbour, a
     column exchange and side-column corrections for each with a W/E one); x, by the
     sha256 of each shard's bytes, bit for bit the one-process mesh of the same shape, 14
     iterations both, the medians side by side, and the stepped run's halo, spmv,
     allreduce and blas1 ms an iteration beside the one-process mesh's
     (chiprun_out/chip_smoke_ranks.json).
 17. (run after phase 16) a graph a rank over NCCL (cg_sharded.MeshLoop with a rank link:
     NCCL's calls captured into the rank's WHILE body).  On one card, in phase 9's one-rank
     group, over a one-rank NCCL group: bench/nccl_graph_probe.py's probe (a 20480-long f64
     row sent to itself and a partial all-gathered inside the captured body, 14 replayed
     iterations bit for bit the same calls run eagerly), then MeshOperator.solve on a rank
     mesh of 2 stencil5 f64 bands on the card (transport "nccl": each dot's partials
     all-gathered by NCCL inside the graph), from the graph against graph=False: x by each
     shard's sha256 bit for bit, 14 iterations, one replay and one read a solve, the
     path's launches.  With two cards or more, 4 ranks (2 below four cards) on cards of
     their own at 20480²: one band a rank in stencil5 f64 and const f32 recompute, and the
     2 x 2 blocks in stencil5 f64, each from the graph a rank against the eager NCCL ranks
     with the same checks.  The phase prints the card count and the legs it ran.

Protocol cuts to keep the run short (none on a median a gate reads): phase 5's CG runs
other than the two phase 13's headline gate compares with take a median of 3 after one
warm-up (CG_CUT_ARGS), its SpMV runs no warm-up; phase 11 runs one round (GRAPH_ROUNDS);
phases 9 and 10 run the multichip CLI's runs of one group size in one group of ranks,
spawned once, each run with its own counts.

On a card every cg_solve of phases 5, 7 and 8 runs the graph loop: a path's launch
counts are its wrappers' eager launches plus its replays' (``cg.LAUNCHES``: the iterations
run, read from the card, times one captured iteration's launches).  Phase 3 also holds
the graph's condition kernel (csrc/graph.cu, which ports no Pallas kernel) to its twin
and times it.

Any failure raises and the exit code is non-zero.  The last lines are the kernels' JSON
record (launches summed over phases 5, 9, 10 and 12-17; the condition kernel's entry and
the three sync kernels' last: like it they port no Pallas kernel) and then {"ok": true,
"device": {...}}.
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
G_CELLS = 20000  # the benchmark's grid (cgbench/configs)
G_HOST = 10240
GRIDS = (37, 1000, 4096)
DIAG, OFFDIAG = 5.0, -1.0
# wrapper name -> (short name, kernel functions in the CUDA source as a regex, source, the
# Pallas wrapper it replaces), in the order of the kernels line
KERNELS = {
    "spmv_stencil5_const_pupdate_dot": ("K1", "pupdate_dot_(vec_)?kernel",
                                        "tpusparse_torch/csrc/stencil5_const.cu",
                                        "tpusparse/kernels/stencil5.py:861"),
    "cg_const_update_recompute": ("K2", "update_recompute_(vec_)?kernel",
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
# the CG graph loop's condition kernel (csrc/graph.cu, kernels/graph.py): it ports no
# Pallas kernel; it is the counterpart of the JAX loop's lax.while_loop condition
COND = "cg_cond"
COND_ENTRY = ("cond", "cond_kernel", "tpusparse_torch/csrc/graph.cu",
              "tpusparse/solvers/cg.py:360 (lax.while_loop's cond; no pallas_call)")
# the counts of K3's, K1's and K2's scalar bodies, by wrapper (stencil5.LAUNCHES): every
# field of the main paths, the sharded runs and phase 6's shapes is aligned for the
# vector bodies, so none of them may launch a scalar body
SCALAR_BODIES = {w: f"{w}_scalar" for w in ("spmv_stencil5_const",
                                             "spmv_stencil5_const_pupdate_dot",
                                             "cg_const_update_recompute")}
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
# the protocol of the CG runs whose median no gate reads: a median of 3 after a warm-up
# (the runs phase 13's headline gate compares with keep the CLI's 3 warm-ups and 10 runs)
CG_CUT_ARGS = ("--runs=3", "--warmup=1")
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
FUSED_TIMED = 3  # timed solves of each, after one warm-up (phase 11 times them too)
# launches a plain twin's time is averaged over in phase 6 (a kernel's: 10); the twins run
# 2-20 times as long as their kernels
PLAIN_REPS = 3
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
# phase 11: the CG graph loop (cg_solve's default on a card) against the eager loop
# (graph=False) at G_BIG² in every single-device loop, mode and dtype that the graph runs:
# label -> (mode, dtype name, cg_solve's loop arguments)
GRAPH_RUNS = {
    "const f64 recompute": ("stencil5-const", "float64", {"recompute_ap": True}),
    "const f32 recompute": ("stencil5-const", "float32", {"recompute_ap": True}),
    "const f32 classic": ("stencil5-const", "float32", {"recompute_ap": False}),
    "const bf16 classic": ("stencil5-const", "bfloat16", {"recompute_ap": False}),
    "stencil5 f64": ("stencil5", "float64", {}),
    "stencil5 f32": ("stencil5", "float32", {}),
    "stencil5 bf16": ("stencil5", "bfloat16", {}),
    "bf16c f32": ("stencil5-bf16c", "float32", {}),
    "csr f64": ("csr", "float64", {}),
    "dia f64": ("dia", "float64", {}),
    "fused stencil5 f64": ("stencil5", "float64", {"fused_pupdate": True}),
    "fused const f64": ("stencil5-const", "float64", {"fused_pupdate": True}),
}
GRAPH_ROUNDS = 1  # rounds of eager, graph, graph, eager after a warm-up solve of each
COND_NODES = 1000  # IF nodes in the graph that times the condition kernel
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
# phase 12: the port's scripts (tpusparse_torch.scripts), each through its main(argv), with
# their outputs in SCRIPTS_DIR; the format table's exports in TABLE_DIR
SCRIPTS_DIR = OUT / "scripts"
TABLE_DIR = SCRIPTS_DIR / "results"
# detect_config's mode whose largest grid (past 2^31 elements a field) one solve runs at;
# its true relative residual's bar; rows a band of the residual's f64 sum
BIG_LABEL = "stencil5-const f32 recompute"
RESIDUAL_TOL = 1e-5
RESIDUAL_BAND = 1024
# the audit's kernels (its five phases and its solves' <r0, r0>), and the launches each
# phase makes: one eager launch, then replays of its graphs: a warm-up chain of 4, then 3
# chains of 4 and 3 of 16
AUDIT_NEEDS = ("spmv_stencil5_const", "cg_update", "p_update",
               "spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute", "dot")
AUDIT_CHAIN_LAUNCHES = 1 + 4 + 3 * (4 + 16)
# the audit's grids: 1024² (L2-resident fields: the loop's one-element kernels show) and
# G_BIG², where the phases must add up to the measured iteration within 80-120%
AUDIT_GRIDS = (1024, G_BIG)
# profile_kernel's applies a trace: this process has profiled for minutes by phase 12, and
# its later traces lost their first kernel records (all 5 of the default --reps in two
# runs), so the trace covers enough applies to keep some
PROFILE_REPS = 200
# run_all's grid, and the kernels its SpMV (stencil5, stencil5-const, csr) and CG runs
# (stencil5 and csr) launch
RUN_ALL_GRID = 4096
RUN_ALL_NEEDS = ("spmv_stencil5", "spmv_stencil5_const", "spmv_ell", "cg_update", "p_update",
                 "dot")
TABLE_SIZES = (1024, 2048, 4096, G_HOST, G_BIG)
# the modes whose cells the table must hold at RUN_ALL_GRID and G_BIG
TABLE_MODES = ("stencil5", "stencil5-bf16c", "stencil5-const", "csr", "bcoo")
# phase 13: the top-level entry points.  The headline benchmark (tpusparse_torch.bench.headline)
# runs in a fresh process a metric (this script with HEADLINE_CHILD): metric -> the kernels
# it must launch (cg: the classic loop K3 K4 K5 K6, the recompute loop K1 K2 K6, the bf16c
# companion K8 K4 K5 K6, each solve a graph replay with the condition kernel; spmv: K8)
HEADLINE_CHILD = "--headline-child"
HEADLINE_DIR = OUT / "headline"
HEADLINE_RUNS = {"cg": RECOMPUTE + ("spmv_stencil5_const", "cg_update", "p_update",
                                    "spmv_stencil5", COND),
                 "spmv": ("spmv_stencil5",)}
HEADLINE_TIMEOUT = 600
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "mode", "loop", "classic_loop_ms",
                 "dtype", "iterations", "total_runs", "valid_runs", "std_ms",
                 "values_carrying_bf16c_ms", "vs_baseline_bf16c", "device")
# the headline's median against phase 5's CLI median of the same loop, relative
HEADLINE_TOL = 0.10
HEADLINE_LOOPS = {"recompute-ap": "const f32 recompute", "classic": "const f32 classic"}
HEADLINE_MIN_VALID = 8
SPMV_MAX_FRACTION = 1.05
# dryrun_multichip's shard counts, and the kernels its mesh must launch: K8 on its row
# pieces with halo rows, K4, K5 and K6 (f64)
DRYRUN_RANKS = (2, 4)
DRYRUN_NEEDS = ("spmv_stencil5", "cg_update", "p_update", "dot")
# phase 14: the multichip CLI without a process group, so one process drives a mesh of
# shards (cg_sharded.MeshOperator), every shard on the card: label -> (mesh shape,
# arguments, the export's loop, the phase-5 run whose solution it must equal, the phase 9/10
# gloo run of the same decomposition whose Sum/Norm2 it must equal bit for bit, or None)
MESH_RUNS = {
    "mesh stencil5 f64 x2": ((2,), ["--mode=stencil5", "--dtype=f64"], "classic",
                             "stencil5 f64", "sharded stencil5 f64 x2"),
    "mesh stencil5 f64 x4": ((4,), ["--mode=stencil5", "--dtype=f64"], "classic",
                             "stencil5 f64", "sharded stencil5 f64 x4"),
    "mesh const f32 recompute x2": ((2,), ["--mode=stencil5-const", "--dtype=f32"],
                                    "recompute-ap", "const f32 recompute", None),
    "mesh const f32 recompute x4": ((4,), ["--mode=stencil5-const", "--dtype=f32"],
                                    "recompute-ap", "const f32 recompute", None),
    "mesh const f64 recompute x4": ((4,), ["--mode=stencil5-const", "--dtype=f64"],
                                    "recompute-ap", "const f64 recompute",
                                    "sharded const f64 recompute x4"),
    "mesh csr f64 x2": ((2,), ["--mode=csr", "--dtype=f64"], "classic", "csr f64", None),
    "mesh csr f64 x4": ((4,), ["--mode=csr", "--dtype=f64"], "classic", "csr f64",
                        "sharded csr f64 x4"),
    "mesh stencil5 f64 2x2": ((2, 2), ["--mode=stencil5", "--dtype=f64"], "classic",
                              "stencil5 f64", "mesh2d stencil5 f64 2x2"),
    "mesh const f64 2x2": ((2, 2), ["--mode=stencil5-const", "--dtype=f64"], "classic",
                           "const f64 recompute", "mesh2d const f64 2x2"),
    "mesh stencil5 bf16 x2": ((2,), ["--mode=stencil5", "--dtype=bf16"], "classic",
                              "stencil5 f64", "sharded stencil5 bf16 x2"),
    "mesh stencil5 bf16 2x2": ((2, 2), ["--mode=stencil5", "--dtype=bf16"], "classic",
                               "stencil5 f64", "mesh2d stencil5 bf16 2x2"),
    "mesh stencil5 f64 --timers x4": ((4,), ["--mode=stencil5", "--dtype=f64", "--timers"],
                                      "host-stepped", "stencil5 f64",
                                      "sharded stencil5 f64 --timers x4"),
}
MESH_ARGS = ["--runs=3", "--warmup=1"]
MESH_SOLVES = 5  # a run's solves: the warm-up, three timed, the one that gives x
# Sum/Norm2 against phase 5's single-device solve of the same mode and dtype: f64 as phases
# 9-10, f32 at its rounding (the shards' partial dots are summed in another order); a bf16
# state against stencil5 f64 within BF16_TOL
MESH_TOL = {"f64": 1e-10, "f32": 1e-5, "bf16": BF16_TOL}
# the grid at which the mesh's x must equal the gloo ranks' bit for bit, and those cases:
# label -> (shards, gloo ranks' 2-D mesh shape or None, mode, dtype name, solver arguments)
MESH_X_GRID = 2048
MESH_X_CASES = {
    "stencil5 f64 x2": (2, None, "stencil5", "float64", {}),
    "const f32 recompute x2": (2, None, "stencil5-const", "float32", {}),
    "csr f64 x2": (2, None, "csr", "float64", {}),
    "stencil5 bf16 x2": (2, None, "stencil5", "bfloat16", {}),
    "stencil5 f64 x4": (4, None, "stencil5", "float64", {}),
    "const f32 recompute x4": (4, None, "stencil5-const", "float32", {}),
    "const f64 recompute x4": (4, None, "stencil5-const", "float64", {}),
    "csr f64 x4": (4, None, "csr", "float64", {}),
    "stencil5 f64 --timers x4": (4, None, "stencil5", "float64", {"stepped": True}),
    "stencil5 f64 2x2": (4, (2, 2), "stencil5", "float64", {}),
    "const f64 2x2": (4, (2, 2), "stencil5-const", "float64", {}),
}
# exchanges and ordered sums a graph times, to read each one's device time
TRANSPORT_REPS = 50
# the mesh solves phase 14 profiles beside phase 7's single-device split of the same solve
MESH_PROFILED = {"mesh stencil5 f64 x4": "stencil5 f64",
                 "mesh const f32 recompute x4": "const f32 recompute",
                 "mesh stencil5 f64 2x2": "stencil5 f64",
                 "mesh stencil5 bf16 x2": "stencil5 bf16"}
# phase 15: the per-card loop (cg_sharded.CardLoop, per_shard=True: a CUDA graph a card,
# the shards meeting through csrc/mesh_sync.cu), its shards sharing the card, against the
# mesh's one graph (MeshLoop) at G_BIG²: label -> (mesh shape, mode, dtype, loop arguments)
CARD_RUNS = {
    "stencil5 f64 x2": ((2,), "stencil5", "float64", {}),
    "stencil5 f64 x4": ((4,), "stencil5", "float64", {}),
    "const f32 recompute x4": ((4,), "stencil5-const", "float32", {}),
    "csr f64 x4": ((4,), "csr", "float64", {}),
    "stencil5 bf16 x2": ((2,), "stencil5", "bfloat16", {}),
    "stencil5 f64 2x2": ((2, 2), "stencil5", "float64", {}),
}
CARD_TIMED = 3  # rounds of one solve of each loop, in turns, after a first solve of each
SYNC_REPS = 50  # launches of a sync kernel in the graph that times it
# the withheld-shard child: a per-card loop of 2 shards at WITHHELD_GRID² f64 whose shard 1
# never runs; shard 0's waits must give up after WITHHELD_BOUND_S
WITHHELD_CHILD = "--withheld-child"
WITHHELD_GRID = 2048
WITHHELD_BOUND_S = 2.0
# the profiled child: a torch.profiler session begun before the kernels load, then the
# per-card loop on PROFILED_SHARDS shards sharing the card at WITHHELD_GRID² f64, in a
# process that is killed after PROFILED_TIMEOUT_S
PROFILED_CHILD = "--profiled-child"
PROFILED_SHARDS = 4
PROFILED_TIMEOUT_S = 240
# phase 16: RANK_MESH_RANKS gloo ranks sharing the card, each driving its share of one mesh
# across the ranks (dist.make_rank_mesh) at G_BIG²: RANK_MESH_SHARDS row bands, or 2-D
# blocks (two a rank), against the one-process mesh of the same shape: label -> (the
# mesh's shards: N bands or an (R, C) mesh, mode, dtype, the loop, the kernels its path
# launches); the stepped run splits a rank mesh's iteration into its --timers buckets
RANK_MESH_RANKS, RANK_MESH_SHARDS = 2, 4
RANK_MESH_CLASSIC = ("spmv_stencil5", "cg_update", "p_update", "dot")
RANK_MESH_RUNS = {
    "stencil5 f64": (RANK_MESH_SHARDS, "stencil5", "float64", "solve", RANK_MESH_CLASSIC),
    "const f32 recompute": (RANK_MESH_SHARDS, "stencil5-const", "float32", "solve",
                            RECOMPUTE),
    # rows cross the ranks
    "2x2 stencil5 f64": ((2, 2), "stencil5", "float64", "solve", RANK_MESH_CLASSIC),
    # a column crosses the ranks
    "1x4 stencil5 f64": ((1, 4), "stencil5", "float64", "solve", RANK_MESH_CLASSIC),
    "stencil5 f64 --timers": (RANK_MESH_SHARDS, "stencil5", "float64", "stepped",
                              RANK_MESH_CLASSIC),
}
RANK_MESH_TIMED = 3  # timed solves of each, after a first one
# phase 17, a graph a rank over NCCL.  On one card: the probe's one-rank NCCL group
# (bench/nccl_graph_probe.py), a G_BIG-long row sent to itself and a partial all-gathered
# inside a captured WHILE body, NCCL_GRAPH_ITERS iterations, bit for bit the same calls
# run eagerly; and in that group the port's own rank mesh (RANK_GRAPH_ONE_CARD: 2 bands on
# the rank's card, transport "nccl", each dot's partials all-gathered by NCCL inside
# MeshLoop's graph), a graph a rank against its eager loop.  With two cards or more: the
# rank cases at G_BIG², a graph a rank against the eager NCCL ranks, 4 ranks (2 below four
# cards; label -> (None for one band a rank, else N bands or the (R, C) blocks, one or two
# a rank; mode, dtype, kernels the path must launch))
NCCL_GRAPH_ITERS = 14
RANK_GRAPH_ONE_CARD = {
    "stencil5 f64 2 bands, one rank": (2, "stencil5", "float64", RANK_MESH_CLASSIC),
}
# and a long solve there (tolerance 0: max_iters ends it) at LONG_GRID², replayed again
# with the rank's wait bound a quarter of its time: the bound is on a stall, not a solve
LONG_GRID, LONG_ITERS = 256, 3000
RANK_GRAPH_CASES = {
    "stencil5 f64 bands": (None, "stencil5", "float64", RANK_MESH_CLASSIC),
    "const f32 recompute bands": (None, "stencil5-const", "float32", RECOMPUTE),
    "2x2 stencil5 f64": ((2, 2), "stencil5", "float64", RANK_MESH_CLASSIC),
}
# and a graph a card for ranks that drive several cards (cg_sharded.RankCardLoop: NCCL's
# calls in the home card's graph, mesh_sync between the rank's cards), shard i on card i,
# against the eager NCCL loop: with two cards one rank drives both in a one-rank NCCL
# group (RANK_CARDS_ONE_RANK); with four, 2 ranks drive 2 cards each (RANK_CARDS_CASES)
RANK_CARDS_PATH = (*RANK_MESH_CLASSIC, "mesh_publish_rows", "mesh_publish_partial",
                   "mesh_wait")
RANK_CARDS_ONE_RANK = {
    "stencil5 f64 2 bands, one rank x 2 cards": (2, "stencil5", "float64", RANK_CARDS_PATH),
}
RANK_CARDS_CASES = {
    "stencil5 f64 4 bands, 2 ranks x 2 cards": (4, "stencil5", "float64", RANK_CARDS_PATH),
    "2x2 stencil5 f64, 2 ranks x 2 cards": ((2, 2), "stencil5", "float64", RANK_CARDS_PATH),
}
RANK_MESH_BUCKETS = ("halo", "spmv", "allreduce", "blas1")
# the sync kernels (csrc/mesh_sync.cu, kernels/mesh_sync.py): they port no Pallas kernel;
# they are the counterparts of the JAX loop's ppermute and psum
SYNC_KERNELS = {
    "mesh_publish_rows": ("sync rows", "publish_rows_kernel",
                          "tpusparse_torch/csrc/mesh_sync.cu",
                          "tpusparse/solvers/cg_sharded.py:468 (lax.ppermute in the "
                          "while_loop; no pallas_call)"),
    "mesh_publish_partial": ("sync partial", "publish_partial_kernel",
                             "tpusparse_torch/csrc/mesh_sync.cu",
                             "tpusparse/solvers/cg_sharded.py:427 (lax.psum in the "
                             "while_loop; no pallas_call)"),
    "mesh_wait": ("sync wait", "wait_kernel", "tpusparse_torch/csrc/mesh_sync.cu",
                  "tpusparse/solvers/cg_sharded.py:446 (lax.psum's sum; no pallas_call)"),
}


def rel(a, b) -> float:
    """max |a - b| / max |b|, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def short(name) -> str:
    """A wrapper's short name: K1-K12, "cond" for the graph condition kernel, or the
    wrapper's own for the streaming probes."""
    if name == COND:
        return COND_ENTRY[0]
    return KERNELS[name][0] if name in KERNELS else name


def scalar_launched(label, counts):
    """Raise if a path launched the scalar body of K3, K1 or K2 (counts: wrapper ->
    launches)."""
    for wrapper, scalar in SCALAR_BODIES.items():
        if counts.get(scalar, 0):
            raise AssertionError(f"{label}: {short(wrapper)}'s scalar body launched "
                                 f"{counts[scalar]} of {counts[wrapper]} {short(wrapper)} "
                                 "launches on fields aligned for the vector body")


def launch_counts(counters) -> dict:
    """{wrapper: launches} summed over the counters' ``LAUNCHES``, zero counts left out."""
    counts = {}
    for c in counters:
        for name, n in c.LAUNCHES.items():
            if n:
                counts[name] = counts.get(name, 0) + n
    return counts


class PathCounts:
    """The launch counts of the main paths, read path by path: every count is set to 0
    just before a path runs and read just after, and the path must have launched each
    kernel it names (K3 through its vector body only).  A path's count of a kernel is its
    wrapper's eager launches plus the launches that replays of the CG loop's graph made
    (``cg.LAUNCHES``: the iterations each replay ran, read from the card, times one
    captured iteration's launches; the condition kernel's), printed as "(n replayed)"."""

    def __init__(self, counters):
        from tpusparse_torch.kernels import graph as graph_kernels
        from tpusparse_torch.solvers import cg

        self.counters = (*counters, graph_kernels)
        self.replays = cg
        self.by_path = {}

    def run(self, label, needs, fn, forbid=()):
        for counter in (*self.counters, self.replays):
            counter.reset_launches()
        out = fn()
        self.record(label, needs, launch_counts((*self.counters, self.replays)),
                    self.replays.LAUNCHES, forbid)
        return out

    def record(self, label, needs, counts, replayed, forbid=()):
        """Keep and check one path's counts ({wrapper: launches}; ``replayed``: the share
        of them that graph replays made): this process's, or another process's."""
        self.by_path[label] = counts
        order = [n for n in KERNELS if n in counts] + [n for n in counts if n not in KERNELS]
        print(f"[launches] {label}: " + ", ".join(
            f"{short(n)} {counts[n]}" + (f" ({replayed[n]} replayed)" if replayed.get(n) else "")
            for n in order), flush=True)
        missing = [f"{short(n)} {n}" for n in needs if counts.get(n, 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels of this path never launched: {missing}")
        stray = [f"{short(n)} {n}" for n in forbid if counts.get(n, 0)]
        if stray:
            raise AssertionError(f"{label}: kernels of another path launched: {stray}")
        scalar_launched(label, counts)

    def totals(self):
        """{wrapper: launches summed over the paths}, the scalar bodies' and the graph
        condition kernel's too."""
        return {name: sum(c.get(name, 0) for c in self.by_path.values())
                for name in (*KERNELS, *SCALAR_BODIES.values(), COND)}


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
    from tpusparse_torch.bench import profiling

    with profiling.recording():  # the time printed is the Kernel_Load span's
        build.lib()
    loads = [sp for sp in profiling.spans() if sp.name == profiling.PHASE_KERNEL_LOAD]
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
    if not loads:
        print(f"[build] loaded before this phase: {build.BUILD}", flush=True)
        return
    how = "built" if loads[-1].attrs["built"] else "loaded an earlier build of the same sources"
    print(f"[build] {how} in {(loads[-1].end_ns - loads[-1].start_ns) / 1e9:.1f} s: "
          f"{build.BUILD}", flush=True)


def k3_counts(st5):
    """(K3 launches, of which the scalar body's)."""
    return (st5.LAUNCHES["spmv_stencil5_const"],
            st5.LAUNCHES[SCALAR_BODIES["spmv_stencil5_const"]])


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
        cut = () if label in HEADLINE_LOOPS.values() else CG_CUT_ARGS
        rc = counts.run(f"cg {label}", needs, lambda: cg_cli.main(
            [f"gen:{G_BIG}", f"--mode={mode}", *extra, *cut, f"--json={path}"]))
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
    missing = [f"{short(n)} {n}" for n in (*KERNELS, COND) if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    return results, fused, launches


def phase_fused(torch, counts, st, results):
    """The fused p-update solves through cg.cg_solve(fused_pupdate=True), each path with
    its own launch counts: one warm-up, then FUSED_TIMED timed solves (the port's stats:
    the median), then one more whose x is checked.  A timed solve drops its x, as the CG
    CLI's do: a solve whose every earlier x is still held captures the graph loop on a
    new solution field (``cg.DeviceLoop``).  Returns {label: (median ms, iterations)}."""
    from tpusparse_torch import ops
    from tpusparse_torch.bench import stats
    from tpusparse_torch.solvers import cg

    out, x_f32 = {}, None
    for label, (mode, dtype_name, iters, fused_pass) in FUSED_RUNS.items():
        dtype = getattr(torch, dtype_name)
        op = ops.get_operator(mode, st, dtype=dtype, device="cuda")

        def solve(keep_x=False):
            t0 = time.perf_counter()
            x, s = cg.cg_solve(op, b_is_ones=True, fused_pupdate=True)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, (x if keep_x else None, s)

        def timed():
            bench, _ = stats.benchmark_solver_with_stats(solve, num_runs=FUSED_TIMED,
                                                         warmup=1)
            return bench, solve(keep_x=True)[1]

        bench, (x, s) = counts.run(label, (fused_pass, "cg_update", "dot"), timed,
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
    with its own launch counts; the wall time of a run includes its operator's build.
    Raises unless every mode gives the same checksums, and those of y = A·ones to 1e-12
    (``generate.stencil5_spmv_checksums``).  Returns {mode: kernel ms}."""
    from tpusparse_torch import generate

    want = generate.stencil5_spmv_checksums(g, DIAG, OFFDIAG)
    spmv_json = OUT / name
    sums, kernel_ms = {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        rc = counts.run(f"spmv {mode} {g}² {dtype}", SPMV_NEEDS[mode], lambda: spmv_cli.main(
            [f"gen:{g}", f"--mode={mode}", f"--dtype={dtype}", "--runs=3", "--warmup=0",
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
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(torch, f, n) for f, n in (
            (plain, PLAIN_REPS), (kern, 10), (kern, 10), (plain, PLAIN_REPS)))
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


def time_bodies(torch, run, work, key, label, smi, kernel="K3"):
    """A kernel's vector body (K3's, or K1's or K2's) against its forced scalar body on the
    same operands, in turns (vector/scalar/scalar/vector); ``run(scalar)`` makes the call.
    Prints both beside the bound; returns (vector ms, scalar ms), each the better of its
    two."""
    t = [_time_ms(torch, lambda sc=sc: run(sc)) for sc in (False, True, True, False)]
    vector, scalar = min(t[0], t[3]), min(t[1], t[2])
    b, by = bound(work, key)
    print(f"[time] {kernel} bodies {label}: vector {vector!r} ms ({100 * b / vector:.1f}% "
          f"of the bound), scalar {scalar!r} ms ({100 * b / scalar:.1f}%), bound {b!r} ms ({by}); "
          f"scalar / vector {scalar / vector:.3f} [{smi}]", flush=True)
    return vector, scalar


def body_entry(ms, work, key, plain_ms=None, library_ms=None):
    """A timing entry of a kernel with two bodies (one body, one shape) beside its bound."""
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
    _vector, scalar = time_bodies(
        torch, lambda sc: st5.spmv_stencil5_const(x, _scalar_body=sc, **kw), work, key,
        label, smi)
    e[f"scalar_{key}"] = body_entry(scalar, work, key, e[key]["plain_ms"],
                                    e[key]["library_ms"])


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


def compare_recompute_bodies(torch, st5, cmp, r, p, x, label):
    """K1 and K2 on the main paths' operands (no halo rows, β and α ≠ 0) in both bodies:
    p', x' and r' bit for bit the twin's, the dots to tolerance, and each launch taking
    the body it should (the vector body on these fresh fields, the scalar body forced)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dtype = r.dtype
    s = torch.tensor(0.37, dtype=dtype, device=r.device)
    pout = torch.empty_like(r)
    pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, **kw)
    for scalar in (False, True):
        body = "scalar" if scalar else "vector"
        before = st5.LAUNCHES[SCALAR_BODIES["spmv_stencil5_const_pupdate_dot"]]
        pk, dk = st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, _scalar_body=scalar,
                                                     **kw)
        if st5.LAUNCHES[SCALAR_BODIES["spmv_stencil5_const_pupdate_dot"]] - before != scalar:
            raise AssertionError(f"K1 {label}: the launch did not take the {body} body")
        cmp.check("spmv_stencil5_const_pupdate_dot", f"{label}, {body} body", dtype,
                  [("p'", pk, pp, "exact"), ("<p',Ap'>", dk, dp, "dot")])
    del pp, pk
    xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p, **kw)
    for scalar in (False, True):
        body = "scalar" if scalar else "vector"
        before = st5.LAUNCHES[SCALAR_BODIES["cg_const_update_recompute"]]
        xk, rk, dk = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p,
                                                   _scalar_body=scalar, **kw)
        if st5.LAUNCHES[SCALAR_BODIES["cg_const_update_recompute"]] - before != scalar:
            raise AssertionError(f"K2 {label}: the launch did not take the {body} body")
        cmp.check("cg_const_update_recompute", f"{label}, {body} body", dtype,
                  [("x'", xk, xp, "exact"), ("r'", rk, rp, "exact"), ("<r',r'>", dk, dp, "dot")])
        del xk, rk


def phase_full_size_recompute(torch, st5, cmp, smi, times):
    """K1's and K2's two bodies at G_BIG² and at the benchmark's 20000², f32 and f64:
    held to the twin (compare_recompute_bodies), then timed against each other in turns
    beside their bounds, into ``times`` (keys "scalar_<state>" at G_BIG², "g20000_<state>"
    and "scalar_g20000_<state>" at 20000²)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    for g in (G_BIG, G_CELLS):
        for dtype in (torch.float32, torch.float64):
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(g)
            x, r, p = (torch.rand(g, g, generator=gen, device=dev, dtype=dtype)
                       for _ in range(3))
            key = dname(dtype).replace("float", "f")
            lab = f"{g}² {dname(dtype)}"
            compare_recompute_bodies(torch, st5, cmp, r, p, x, lab)
            pout = torch.empty_like(r)
            s = torch.tensor(0.37, dtype=dtype, device=dev)
            a = torch.tensor(1e-3, dtype=dtype, device=dev)  # x and r drift slowly
            n, f = r.numel(), nbytes(r)
            for name, short_name, work, run in (
                    ("spmv_stencil5_const_pupdate_dot", "K1", (3 * f, 10 * n),
                     lambda sc: st5.spmv_stencil5_const_pupdate_dot(
                         s, r, p, out=pout, _scalar_body=sc, **kw)),
                    ("cg_const_update_recompute", "K2", (5 * f, 12 * n),
                     lambda sc: st5.cg_const_update_recompute(a, x, r, p, _scalar_body=sc,
                                                              **kw))):
                vector, scalar = time_bodies(torch, run, work, key, lab, smi, short_name)
                e = times[name]
                if g == G_BIG:
                    e[f"scalar_{key}"] = body_entry(scalar, work, key)
                else:
                    e[f"g{g}_{key}"] = body_entry(vector, work, key)
                    e[f"scalar_g{g}_{key}"] = body_entry(scalar, work, key)
            del x, r, p, pout


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
            vector, scalar = time_bodies(torch, lambda sc: k3_pieces(st5, p, hp, hn, y, sc),
                                         work, key, lab + ", three pieces", smi)
            plain = _time_ms(torch, lambda: st5.spmv_stencil5_const_plain(p, hp, hn,
                                                                          with_dot=True, **kw))
            times["spmv_stencil5_const"][f"{skey}_{key}"] = body_entry(vector, work, key, plain)
            times["spmv_stencil5_const"][f"{skey}_scalar_{key}"] = body_entry(scalar, work, key,
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
    under torch.profiler at G_BIG² (after an unprofiled one, which captures the graph
    loop), its device time split by kernel.  "idle" is the solve's unprofiled median from
    phase 5 (``medians``: label -> ms) minus the summed device time of the profiled
    solve's kernels, memsets and copies: a difference, not a timeline.  The profiled
    solve's own wall time is printed beside it only as an aside, since it also holds the
    profiler's cost.  The full tables go to chiprun_out/profile.txt.  The solver's phase
    scopes (``bench.profiling``) are ranges, not device work, and stay out of the sums
    (the graph loop enters them at its capture only).  Returns {label: {kernel group:
    device ms}}."""
    from torch.profiler import ProfilerActivity, profile

    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5
    from tpusparse_torch.solvers import cg

    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    tables, splits = [], {}
    # CUPTI reports every kernel of a CUDA graph only if it was running when the graph was
    # captured: on the H100 a replay of a graph captured before the process's first profile
    # showed the WHILE body's first pass only (2 of 17 iterations' kernels), one captured
    # after a profile all of them.  So a profile runs before any capture here.
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    dtypes = {"--dtype=f64": torch.float64, "--dtype=bf16": torch.bfloat16}
    solves = [(label, mode, next((dt for a, dt in dtypes.items() if a in extra), torch.float32),
               {"recompute_ap": False if "--loop=classic" in extra else None})
              for label, (mode, extra, _iters, _needs) in CG_RUNS.items()
              if label not in BF16_RUNS[1:]]  # one bf16 solve: stencil5's
    solves += [(label, mode, getattr(torch, dtype_name), {"fused_pupdate": True})
               for label, (mode, dtype_name, _iters, _pass) in FUSED_RUNS.items()]
    for label, mode, dtype, kwargs in solves:
        op = ops.get_operator(mode, st, dtype=dtype, device="cuda")
        cg.cg_solve(op, b_is_ones=True, **kwargs)  # the graph loop's capture
        torch.cuda.synchronize()
        splits[label] = profile_split(torch, lambda: cg.cg_solve(op, b_is_ones=True, **kwargs),
                                      f"{label} {G_BIG}²", medians[label], "phase 5's",
                                      tables, smi)
        op.free()
        del op
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "profile.txt").write_text("\n\n".join(tables))
    return splits


def profile_split(torch, solve, label, median, whose, tables, smi):
    """One ``solve()`` (returning (x, CGStats)) under torch.profiler: its device time by
    kernel group, printed beside ``median`` (``whose`` unprofiled median of the same solve)
    and the idle share, median - busy; its table appended to ``tables``.  Returns {kernel
    group: device ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpusparse_torch.bench import profiling

    groups = [(short, re.compile(rf"(?<![a-z_]){fn}")) for short, fn, _s, _r in
              KERNELS.values()]
    groups.append(("final sums", re.compile(r"(?<![a-z_])final_sum_kernel")))
    groups.append(("cond", re.compile(r"(?<![a-z_])cond_kernel")))
    groups.append(("cuSPARSE", re.compile(r"cusparse|csrmv", re.IGNORECASE)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        x, stats = solve()
        wall = (time.perf_counter() - t0) * 1e3
    del x
    # the program's scopes appear as device rows too (their ranges on the card's
    # timeline): leave them out, or their kernels would count twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in profiling.NAMES]
    if not rows:
        raise AssertionError(f"profile {label}: the profiler saw no device time")
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    split = {}
    for e in rows:
        g = next((g for g, pat in groups if pat.search(e.key)), "other device")
        split[g] = split.get(g, 0.0) + e.self_device_time_total / 1e3
    parts = ", ".join(f"{g} {ms!r} ms ({100 * ms / median:.1f}%)" for g, ms in split.items())
    print(f"[profile] {label}, {stats.iterations} iterations: {whose} median {median!r} ms, "
          f"device busy {busy!r} ms; {parts}; idle (median - busy) {median - busy!r} ms "
          f"({100 * (median - busy) / median:.1f}%); the profiled solve's wall {wall!r} ms "
          f"[{smi}]", flush=True)
    tables.append(f"=== {label}: wall {wall!r} ms\n"
                  + prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=16, max_name_column_width=70))
    return split


def compare_cond(torch, smi):
    """The graph condition kernel against its twin (``graph.cond_plain``, the condition
    read on the host): an IF node whose body sets a flag, replayed for (k, rr, tol²)
    around the edges (equal, zero, NaN), in f32 and f64; then its time: a graph of
    COND_NODES IF nodes whose condition is false, so that each costs its kernel and the
    skipped node, against the twin's two reads on the host clock.  Returns its kernels
    line entry (max_abs_err: the largest |kernel - twin| over the flags)."""
    from tpusparse_torch.kernels import graph as graph_kernels

    cases = [(0, 1.0, 0.5), (6, 1.0, 0.5), (7, 1.0, 0.5), (8, 1.0, 0.5), (0, 0.0, 0.0),
             (0, 0.5, 0.5), (0, 0.5, 0.25), (0, float("nan"), 0.1), (3, 1e-30, 0.0),
             (-1, 2.0, 1.0)]
    graph_kernels.preload("cuda")
    err, checked = 0.0, 0
    for acc in (torch.float32, torch.float64):
        k = torch.zeros((), dtype=torch.int64, device="cuda")
        rr, tol2 = (torch.zeros((), dtype=acc, device="cuda") for _ in range(2))
        flag = torch.zeros((), dtype=torch.int32, device="cuda")
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            with graph_kernels.conditional(graph_kernels.IF, k, 7, rr, tol2):
                flag.fill_(1)
        for kv, rv, tv in cases:
            k.fill_(kv)
            rr.fill_(rv)
            tol2.fill_(tv)
            flag.zero_()
            g.replay()
            err = max(err, abs(int(flag) - int(graph_kernels.cond_plain(k, 7, rr, tol2))))
            checked += 1
        del g
    print(f"[compare] cond {COND}: {checked} conditions, largest |kernel - twin| {err} "
          f"(tol 0)", flush=True)
    if err:
        raise AssertionError("the graph condition kernel disagrees with its twin")
    k = torch.full((), 7, dtype=torch.int64, device="cuda")
    rr, tol2 = (torch.ones((), dtype=torch.float64, device="cuda") for _ in range(2))
    flag = torch.zeros((), dtype=torch.int32, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(COND_NODES):
            with graph_kernels.conditional(graph_kernels.IF, k, 7, rr, tol2):
                flag.fill_(1)
    ms = _time_ms(torch, g.replay) / COND_NODES
    if int(flag):
        raise AssertionError("a false condition ran its node's body")
    t0 = time.perf_counter()
    for _ in range(200):
        graph_kernels.cond_plain(k, 7, rr, tol2)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 200
    bound_ms, bound_by = bound((nbytes(k, rr, tol2), 2), "f64")
    print(f"[time] cond {COND} f64: kernel and skipped IF node {ms!r} ms, plain (two "
          f"reads) {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) [{smi}]", flush=True)
    return {"max_abs_err": err, "max_rel_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_graph(torch, smi):
    """Phase 11: the CG graph loop against the eager loop at G_BIG² in every case of
    GRAPH_RUNS: after one warm-up solve of each (the graph's: its capture), the same
    iterations (14 in f64) and x bit for bit; then GRAPH_ROUNDS rounds of eager, graph,
    graph, eager solves, host clock around each (a solve ends in its read of the card),
    their medians and each loop's host reads and replays a solve (the graph's: one of
    each).  Writes chiprun_out/chip_smoke_graph.json; returns it."""
    import statistics

    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5
    from tpusparse_torch.solvers import cg

    t_phase = time.perf_counter()
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    out = {}
    for label, (mode, dtype_name, kwargs) in GRAPH_RUNS.items():
        op = ops.get_operator(mode, st, dtype=getattr(torch, dtype_name), device="cuda")

        def solve(graph):
            cg.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, s = cg.cg_solve(op, b_is_ones=True, graph=graph, **kwargs)
            return (time.perf_counter() - t0) * 1e3, x, s, reads_of(cg.COUNTS)

        _, x_e, s_e, reads_e = solve(False)
        _, x_g, s_g, reads_g = solve(True)
        same = torch.equal(x_g, x_e)
        del x_e, x_g
        iters = s_e.iterations
        if not (s_e.converged and s_g.iterations == iters and same
                and (dtype_name != "float64" or iters == 14)):
            raise AssertionError(f"graph {label}: {s_g.iterations} iterations against the "
                                 f"eager loop's {iters}, x bit for bit: {same}")
        times = {False: [], True: []}
        for _ in range(GRAPH_ROUNDS):
            for graph in (False, True, True, False):
                ms, x, s, reads = solve(graph)
                del x
                times[graph].append(ms)
                want = {"host_reads": 1, "replays": 1} if graph else \
                    {"host_reads": iters + 2, "replays": 0}
                if s.iterations != iters or reads != want:
                    raise AssertionError(f"graph {label} (graph={graph}): {s.iterations} "
                                         f"iterations, {reads}, want {iters} and {want}")
        e_ms, g_ms = statistics.median(times[False]), statistics.median(times[True])
        out[label] = {"mode": mode, "dtype": dtype_name, **kwargs, "iterations": iters,
                      "eager_median_ms": e_ms, "graph_median_ms": g_ms,
                      "eager_ms": times[False], "graph_ms": times[True],
                      "eager_host_reads": iters + 2, "graph_host_reads": 1,
                      "graph_replays": 1, "x_bit_for_bit": same, "device": smi}
        print(f"[graph] {label} {G_BIG}²: {iters} iterations, x bit for bit; median graph "
              f"{g_ms!r} ms against eager {e_ms!r} ms (eager - graph {e_ms - g_ms!r} ms) "
              f"over {len(times[True])} solves each; host reads a solve: graph 1 (1 replay), "
              f"eager {iters + 2} [{smi}]", flush=True)
        op.free()
        del op
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_graph.json").write_text(json.dumps(out, indent=1))
    print(f"[graph] phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


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


def _rank_group(device, runs, jobs):
    """The ranks of every run and job of one group size, spawned once by
    dist.launch_local: each phase-9/10 run's multichip CLI in turn (``_sharded_rank``: its
    own launch and halo counts), then each job (a rank function of this script for a
    later check, and its arguments: ``_bf16c_rank``, phase 14's ``_mesh_x_rank``, phase
    16's ``_rank_mesh_rank``, phase 17's ``nccl_graph_probe.rank_probe`` and
    ``_rank_graph_rank``), the card's cached memory released after each.  Returns
    ([each run's rc], {job's name: its rank-0 result})."""
    import torch

    rcs = []
    for argv, counts_path in runs:
        rcs.append(_sharded_rank(device, argv, counts_path))
        torch.cuda.empty_cache()
    out = {}
    for fn, args in jobs:
        out[fn.__name__] = fn(device, *args)
        torch.cuda.empty_cache()
    return rcs, out


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


def multichip_runs(runs):
    """Every run of ``runs`` (label -> (ranks, the multichip CLI's arguments)) in groups
    of their size: {ranks: [(label, the CLI's argv, its export, its counts' path
    prefix)]}."""
    groups = {}
    for label, (n, extra) in runs.items():
        slug = re.sub(r"[^a-z0-9]+", "_", label)
        path, counts_path = OUT / f"chip_smoke_{slug}.json", SHARDED_DIR / slug
        argv = [f"gen:{G_BIG}", *extra, *SHARDED_ARGS, f"--json={path}"]
        groups.setdefault(n, []).append((label, argv, path, counts_path))
    return groups


def launch_ranks(n, group, jobs, smi):
    """One group of n ranks sharing the card, spawned once, for every run of ``group``
    (``multichip_runs``) and every job of ``jobs`` (``_rank_group``): ({label: rc}, {job:
    its rank-0 result})."""
    from tpusparse_torch import dist

    t0 = time.perf_counter()
    rcs, out = dist.launch_local(_rank_group, n,
                                 [(argv, str(counts)) for _l, argv, _p, counts in group],
                                 jobs, device="cuda")
    print(f"[sharded] {n} rank(s) sharing the card: {len(group)} runs and "
          f"{[fn.__name__ for fn, _ in jobs]} in one group, {time.perf_counter() - t0:.1f} s "
          f"with the spawn [{smi}]", flush=True)
    return dict(zip((label for label, *_ in group), rcs)), out


def check_multichip(label, n, rc, path, counts_path, loop, ref_label, needs, halo_missing,
                    results, smi, launches):
    """One multichip CLI run on n ranks sharing the card, from its ranks' own launch
    counts: every rank must launch ``needs``, ``halo_missing(r, counts)`` says what rank r
    lacks on its exchanged halos, the solution must equal phase 5's ``ref_label`` to
    1e-10 in 14 iterations (a bf16 state's: to BF16_TOL, in any count), and a
    host-stepped run's four buckets must be > 0 and sum to no more than its median.  Adds
    the ranks' launches to ``launches``; returns the export."""
    res = json.loads(path.read_text())
    bf16 = res["dtype"] == "bf16"  # any iteration count, x within BF16_TOL
    tol = BF16_TOL if bf16 else 1e-10
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
        scalar_launched(f"{label} rank {r}", counts["LAUNCHES"])
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
          f"{errs['solution_norm']:.3e} against phase 5's {ref_label} (tol {tol:g}) [{smi}]",
          flush=True)
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
    Every piece of work on ranks that shares the card runs here, one group of ranks a
    group size, spawned once (``launch_ranks``): this phase's runs, phase 10's, the bf16c
    check, phase 14's gloo ranks of its x parity, phase 16's rank meshes and phase 17's
    one-rank NCCL group (the probe and the rank mesh on its card); the later phases check
    theirs.  Returns ({wrapper: launches
    summed over this phase's runs and ranks}, {"mesh2d": {phase 10's label: (the ranks'
    rc, its export, its counts' path prefix)}, "mesh_x": {ranks: phase 14's gloo
    results}, "rank_mesh": phase 16's, "nccl_graph": phase 17's one-card legs})."""
    from tpusparse_torch.bench import nccl_graph_probe

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    SHARDED_DIR.mkdir(parents=True, exist_ok=True)
    launches, later = {}, {"mesh2d": {}, "mesh_x": {}}
    groups = multichip_runs({
        **{label: (n, [*extra, f"--chips={n}"])
           for label, (n, extra, *_) in SHARDED_RUNS.items()},
        **{label: (nr * nc, [*extra, f"--mesh2d={nr}x{nc}"])
           for label, ((nr, nc), extra, *_) in MESH2D_RUNS.items()}})
    jobs = {n: [(_mesh_x_rank, (MESH_X_GRID, {label: c for label, c in MESH_X_CASES.items()
                                              if c[0] == n}))]
            for n in sorted({c[0] for c in MESH_X_CASES.values()})}
    jobs[2] = [(_bf16c_rank, ()), *jobs[2]]
    jobs[1] = [*jobs.get(1, []), (nccl_graph_probe.rank_probe, (G_BIG, NCCL_GRAPH_ITERS)),
               (_rank_graph_rank, (RANK_GRAPH_ONE_CARD, "nccl")),
               (_rank_graph_long_rank, (LONG_GRID, LONG_ITERS))]
    jobs[RANK_MESH_RANKS] = [*jobs.get(RANK_MESH_RANKS, []),
                             (_rank_mesh_rank, (RANK_MESH_RUNS, RANK_MESH_TIMED))]
    for n in sorted(set(groups) | set(jobs)):
        group = groups.get(n, [])
        rcs, out = launch_ranks(n, group, jobs.get(n, []), smi)
        if "_mesh_x_rank" in out:
            later["mesh_x"][n] = out["_mesh_x_rank"]
        if "_rank_mesh_rank" in out:
            later["rank_mesh"] = out["_rank_mesh_rank"]
        if "rank_probe" in out:
            later["nccl_graph"] = (out["rank_probe"], out["_rank_graph_rank"],
                                   out["_rank_graph_long_rank"])
        bf16c = out.get("_bf16c_rank")
        for label, _argv, path, counts_path in group:
            if label in MESH2D_RUNS:
                later["mesh2d"][label] = (rcs[label], path, counts_path)
                continue
            _n, _extra, loop, ref_label, needs, halo_needs = SHARDED_RUNS[label]
            res = check_multichip(
                label, n, rcs[label], path, counts_path, loop, ref_label, needs,
                lambda r, counts, n=n, halo_needs=halo_needs: _band_halo_missing(
                    n, r, counts, halo_needs), results, smi, launches)
            if n == 1:
                single = results[ref_label]["timing"]["total_median_ms"]
                median = res["timing"]["total_median_ms"]
                print(f"[sharded] {label}: one rank's median {median!r} ms against "
                      f"phase 5's single-device {ref_label} median {single!r} ms: the "
                      f"sharded machinery and its host-read dots cost {median - single!r} "
                      f"ms a solve [{smi}]", flush=True)
        if bf16c is not None:
            equal, its = bf16c
            print(f"[sharded] stencil5-bf16c f32 on 2 ranks: {its[1]} iterations, x equal "
                  f"to stencil5 f32's ({its[0]} iterations) bit for bit: {equal}",
                  flush=True)
            if not equal or its[0] != its[1]:
                raise AssertionError("sharded stencil5-bf16c x differs from sharded "
                                     "stencil5 f32 x")
    print(f"[sharded] phase 9 took {time.perf_counter() - t_phase:.1f} s (the rank work of "
          f"phases 10, 14 and 16 among it)", flush=True)
    return launches, later


def phase_mesh2d(results, smi, runs):
    """Phase 10: the multichip CLI's 2-D block decomposition (--mesh2d) at G_BIG² f64, its
    ranks sharing the card, each run from its ranks' own launch counts (``runs``: what
    phase 9's 4-rank group ran for it); each median beside phase 9's 4-rank row-band
    median of the same mode.  Returns {wrapper: launches summed over the runs and
    ranks}."""
    t_phase = time.perf_counter()
    launches = {}
    for label, (mesh, _extra, loop, ref_label, needs, band_label) in MESH2D_RUNS.items():
        rc, path, counts_path = runs[label]
        res = check_multichip(
            label, mesh[0] * mesh[1], rc, path, counts_path, loop, ref_label, needs,
            lambda r, counts, mesh=mesh, k=needs[0]: _block_halo_missing(mesh, r, counts, k),
            results, smi, launches)
        if res["solver"] != f"tpusparse-cg-sharded2d-{mesh[0]}x{mesh[1]}":
            raise AssertionError(f"{label}: solver {res['solver']}")
        band = OUT / f"chip_smoke_{re.sub(r'[^a-z0-9]+', '_', band_label)}.json"
        band_ms = json.loads(band.read_text())["timing"]["total_median_ms"]
        print(f"[mesh2d] {label}: median {res['timing']['total_median_ms']!r} ms against "
              f"phase 9's {band_label} {band_ms!r} ms [{smi}]", flush=True)
    print(f"[mesh2d] phase 10 took {time.perf_counter() - t_phase:.1f} s (its checks; its "
          f"runs ran in phase 9)", flush=True)
    return launches


def exact_cg_iterations(g, diag=DIAG, offdiag=OFFDIAG, tol=1e-6, nodes=64):
    """(iterations, [relative residual after each]) of CG in exact arithmetic on the g x g
    constant stencil with b = ones, x0 = 0, stopping once ‖r‖ <= tol·‖b‖: the count a
    solve at g must take, whatever g, with no solve at g.

    A = diag·I + offdiag·(S⊗I + I⊗S), S the path's adjacency (eigenvalues 2cos(kπ/(g+1)),
    sine eigenvectors), so b = 1⊗1 meets eigenvalue a_i + a_j (a_k = diag/2 +
    offdiag·2cos(kπ/(g+1))) with weight c_i²c_j² (c_k the eigenvector's sum, in closed
    form).  CG's residuals are the orthogonal polynomials of that measure, so the k-th
    residual depends only on its moments up to 2k.  The moments of a sum of two
    independent draws are the binomial convolution of the one-dimensional ones, so the
    product of two ``nodes``-point Gauss rules of the one-dimensional measure (Lanczos
    on diag(a) from c, fully reorthogonalized) has the same moments up to 2·nodes − 1:
    CG on that diagonal problem of nodes² points, in f64 (condition number at most 9),
    gives the first nodes − 1 residuals of the g² problem."""
    import numpy as np

    k = np.arange(1, g + 1, dtype=np.float64)
    theta = np.pi / (g + 1)
    a = diag / 2 + offdiag * 2 * np.cos(k * theta)
    c = (np.sqrt(2 / (g + 1)) * np.sin(g * k * theta / 2) * np.sin(k * np.pi / 2)
         / np.sin(k * theta / 2))
    n = min(nodes, g)
    complete = n == g  # the rule has every point of the measure
    q_basis = np.zeros((g, n))
    alpha, beta = np.zeros(n), np.zeros(n)
    q = c / np.linalg.norm(c)
    for j in range(n):
        q_basis[:, j] = q
        v = a * q
        alpha[j] = q @ v
        for _ in range(2):
            v -= q_basis[:, :j + 1] @ (q_basis[:, :j + 1].T @ v)
        beta[j] = np.linalg.norm(v)
        if beta[j] < 1e-13 * np.abs(a).max():  # the measure has j + 1 points
            n, complete = j + 1, True
            break
        q = v / beta[j]
    lam, vecs = np.linalg.eigh(np.diag(alpha[:n]) + np.diag(beta[:n - 1], 1)
                               + np.diag(beta[:n - 1], -1))
    w = vecs[0] ** 2 * (c @ c)
    lam2 = (lam[:, None] + lam[None, :]).ravel()
    r = np.sqrt(w[:, None] * w[None, :]).ravel()
    p, rr = r.copy(), r @ r
    bb, res = rr, []
    while rr > tol * tol * bb:
        if len(res) >= n - 1 and not complete:
            raise ValueError(f"more than {n - 1} iterations: raise nodes")
        ap = lam2 * p
        step = rr / (p @ ap)
        r = r - step * ap
        rr_new = r @ r
        p = r + (rr_new / rr) * p
        rr = rr_new
        res.append(float(np.sqrt(rr / bb)))
    return len(res), res


def big_solve(torch, counts, smi):
    """detect_config's largest f32 stencil5-const recompute grid (more than 2^31 elements a
    field): one solve that captures the graph loop, then one replay, each taking exactly
    the iterations of CG in exact arithmetic at that grid (``exact_cg_iterations``: 14 at
    20480², fewer on larger grids, where the boundary layer that the later iterations
    resolve is a smaller share of ‖b‖); then, the operator's loop freed, the true
    relative residual ‖1 − A·x‖ / ‖1‖ with A·x from K3 and the norm summed in f64 over row
    bands, at most RESIDUAL_TOL; K3's rows of the band that holds element 2^31 and of the
    last band equal its plain twin's bit for bit.  Returns the record phase 12 keeps."""
    from tpusparse_torch import ops
    from tpusparse_torch.formats import Stencil5
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.scripts import detect_config
    from tpusparse_torch.solvers import cg

    total = torch.cuda.get_device_properties(0).total_memory
    g, wpp, _cap = detect_config.grids(total)[BIG_LABEL]
    if g * g < 2 ** 31:
        raise AssertionError(f"detect_config's {BIG_LABEL} grid {g} holds {g * g} < 2^31 "
                             "elements a field")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    op = ops.get_operator("stencil5-const", Stencil5(grid_size=g, planes=None,
                                                     constant=(DIAG, OFFDIAG)),
                          dtype=torch.float32, device="cuda")

    def solve():
        torch.cuda.synchronize()
        t = time.perf_counter()
        x, s = cg.cg_solve(op, b_is_ones=True, recompute_ap=True)
        return (time.perf_counter() - t) * 1e3, x, s

    first_ms, x, s_first = counts.run(f"detect_config big solve {g}² (capture)", RECOMPUTE,
                                      solve)
    del x
    solve_ms, x, s = counts.run(f"detect_config big solve {g}² (replay)", RECOMPUTE, solve)
    op.free()
    del op
    y = counts.run(f"detect_config big solve {g}²: A·x", ("spmv_stencil5_const",),
                   lambda: st5.spmv_stencil5_const(x, diag=DIAG, offdiag=OFFDIAG))
    finite = bool(torch.isfinite(x).all())
    twin_equal = []
    for i0 in (2 ** 31 // g - RESIDUAL_BAND // 2, g - RESIDUAL_BAND):
        i1 = i0 + RESIDUAL_BAND
        twin = st5.spmv_stencil5_const_plain(
            x[i0:i1], x[i0 - 1:i0], x[i1:i1 + 1] if i1 < g else None, diag=DIAG,
            offdiag=OFFDIAG)
        twin_equal.append(bool(torch.equal(twin, y[i0:i1])))
        del twin
    del x
    rr = torch.zeros((), dtype=torch.float64, device="cuda")
    for i0 in range(0, g, RESIDUAL_BAND):
        rr += y[i0:i0 + RESIDUAL_BAND].double().sub_(1.0).square_().sum()
    residual = float(rr.sqrt()) / g  # ‖b‖ = g for b = ones
    del y
    peak = torch.cuda.max_memory_allocated()
    exact, exact_res = exact_cg_iterations(g)
    rec = {"label": BIG_LABEL, "grid": g, "elements": g * g, "words_per_point": wpp,
           "iterations": [s_first.iterations, s.iterations], "exact_iterations": exact,
           "exact_relative_residual": exact_res[-1], "k3_twin_bands_equal": twin_equal,
           "converged": [s_first.converged, s.converged], "first_solve_ms": first_ms,
           "solve_ms": solve_ms, "true_relative_residual": residual,
           "recurrence_relative_residual": s.relative_residual, "x_finite": finite,
           "peak_allocated_bytes": peak, "held_before_bytes": held,
           "card_total_bytes": total, "peak_share": peak / total,
           "wall_s": time.perf_counter() - t0, "device": smi}
    print(f"[detect_config] {BIG_LABEL} at detect_config's largest grid {g}² ({g * g} "
          f"elements a field, {g * g / 2 ** 31:.3f} × 2^31): {s_first.iterations} / "
          f"{s.iterations} iterations (capture / replay; exact arithmetic: {exact}, its "
          f"relative residual {exact_res[-1]!r}), first solve {first_ms!r} ms, "
          f"replayed solve {solve_ms!r} ms; true relative residual {residual!r} (tol "
          f"{RESIDUAL_TOL:g}; the recurrence's {s.relative_residual!r}); K3 against its "
          f"twin on the band at element 2^31 and the last band: {twin_equal}; peak allocated "
          f"{peak / 1e9:.2f} GB = {100 * peak / total:.1f}% of the card's {total / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB held before) [{smi}]", flush=True)
    if not (s_first.iterations == s.iterations == exact and s.converged and finite
            and residual <= RESIDUAL_TOL and all(twin_equal)):
        raise AssertionError(f"detect_config big solve at {g}²: {rec}")
    return rec


def collect_table_exports():
    """The exports phase 5 and phase 12 wrote, under the format table's names in
    TABLE_DIR: spmv_<g>_h100_<mode>.json (the sweep's 1024²-4096², run_all's 4096², phase
    5's 20480² and 10240² SpMV CLI runs, f32), run_all's CG exports as
    cg[_baseline_<mode>]_4096_h100.json, and phase 8's probe_ceiling.json."""
    import shutil

    TABLE_DIR.mkdir(parents=True, exist_ok=True)
    pairs = []
    for p in (SCRIPTS_DIR / "sweep").glob("sweep_spmv_*_*.json"):
        g, mode = re.match(r"sweep_spmv_(\d+)_(.+)\.json$", p.name).groups()
        pairs.append((p, f"spmv_{g}_h100_{mode}.json"))
    jdir = SCRIPTS_DIR / "run_all" / "json"
    for p in jdir.glob("spmv_*.json"):
        pairs.append((p, f"spmv_{RUN_ALL_GRID}_h100_{p.stem[len('spmv_'):]}.json"))
    for stem, g in (("chip_smoke_spmv", G_BIG), ("chip_smoke_spmv_host", G_HOST)):
        for p in OUT.glob(f"{stem}_*.json"):
            mode = p.stem[len(stem) + 1:]
            if mode in SPMV_NEEDS:
                pairs.append((p, f"spmv_{g}_h100_{mode}.json"))
    pairs += [(jdir / "cg_single.json", f"cg_{RUN_ALL_GRID}_h100.json"),
              (jdir / "cg_baseline_bcoo.json", f"cg_baseline_bcoo_{RUN_ALL_GRID}_h100.json"),
              (jdir / "cg_baseline_csr.json", f"cg_baseline_csr_{RUN_ALL_GRID}_h100.json"),
              (OUT / "probe_ceiling.json", "probe_ceiling.json")]
    for src, name in pairs:
        shutil.copyfile(src, TABLE_DIR / name)
    print(f"[scripts] {len(pairs)} exports under the format table's names in {TABLE_DIR}",
          flush=True)


def phase_scripts(torch, counters, smi):
    """Phase 12: the port's scripts (tpusparse_torch.scripts), each through main(argv),
    writing into SCRIPTS_DIR, each run read from its own launch counts.  Returns
    {wrapper: launches summed over its runs}."""
    from tpusparse_torch.scripts import (audit_cg_iteration, detect_config, format_table,
                                         profile_kernel, run_all, sharded_compare, sweep)

    t_phase = time.perf_counter()
    counts = PathCounts(counters)
    SCRIPTS_DIR.mkdir(parents=True, exist_ok=True)

    def run(label, needs, main, argv):
        t0 = time.perf_counter()
        rc = counts.run(label, needs, lambda: main(argv))
        print(f"[scripts] {label}: rc {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            raise AssertionError(f"{label}: rc {rc}")

    torch.cuda.empty_cache()
    run("detect_config", (), detect_config.main, [])
    big = big_solve(torch, counts, smi)

    audits = {}
    for g in AUDIT_GRIDS:
        path = TABLE_DIR / f"cg_iter_audit_{g}_h100.json"
        run(f"audit_cg_iteration {g}²", AUDIT_NEEDS, audit_cg_iteration.main,
            [f"--grid={g}", f"--out={path}"])
        audits[g] = audit = json.loads(path.read_text())
        for name, phase in audit["phases"].items():
            wrapper = audit_cg_iteration.PHASES[name][1]
            if phase["launches"] != AUDIT_CHAIN_LAUNCHES:
                raise AssertionError(f"audit {g}² phase {name}: {phase['launches']} "
                                     f"launches of {wrapper}, want {AUDIT_CHAIN_LAUNCHES}")
            print(f"[audit] {g}² {name}: {phase['ms']!r} ms, {phase['launches']} launches of "
                  f"{short(wrapper)} {wrapper}, {100 * phase['bound_share']:.1f}% of its "
                  f"bound {phase['bound_ms']!r} ms [{smi}]", flush=True)
        for loop in ("classic_loop", "recompute_loop"):
            r = audit[loop]
            print(f"[audit] {g}² {loop}: {r['iterations']} iterations, phases "
                  f"{r['phase_sum_ms']!r} ms against the measured iteration "
                  f"{r['per_iter_ms']!r} ms ((solve {r['solve_ms']!r} - fixed "
                  f"{audit['fixed_overhead_ms']!r}) / {r['iterations']}): closure "
                  f"{r['closure_pct']!r}% [{smi}]", flush=True)
            if r["iterations"] != exact_cg_iterations(g)[0]:
                raise AssertionError(f"audit {g}² {loop}: {r['iterations']} iterations")
            if g == G_BIG and not 80 <= r["closure_pct"] <= 120:
                raise AssertionError(f"audit {g}² {loop}: closure {r['closure_pct']}%")

    traces = SCRIPTS_DIR / "traces"
    run("profile_kernel gen:4096", ("spmv_stencil5", "spmv_stencil5_const"),
        profile_kernel.main, ["gen:4096", "--mode=stencil5,stencil5-const",
                              f"--reps={PROFILE_REPS}", f"--outdir={traces}"])
    for mode, wrapper in (("stencil5", "spmv_stencil5"), ("stencil5-const",
                                                          "spmv_stencil5_const")):
        found = sorted((traces / f"stencil5-4096x4096_{mode}").glob("*.pt.trace.json"))
        events = json.loads(found[-1].read_text())["traceEvents"] if found else []
        named = [e for e in events if e.get("cat") == "kernel"
                 and re.search(KERNELS[wrapper][1], e.get("name", ""))]
        if not named:
            raise AssertionError(f"profile_kernel {mode}: no trace naming "
                                 f"{KERNELS[wrapper][1]} in {found}")
        print(f"[scripts] profile_kernel {mode}: {found[-1].name} holds {len(named)} "
              f"records of {KERNELS[wrapper][1]} for its {PROFILE_REPS} applies", flush=True)

    run(f"run_all --size={RUN_ALL_GRID}", RUN_ALL_NEEDS, run_all.main,
        [f"--size={RUN_ALL_GRID}", f"--outdir={SCRIPTS_DIR / 'run_all'}"])
    run("sweep spmv", ("spmv_stencil5", "spmv_ell"), sweep.main,
        ["spmv", f"--outdir={SCRIPTS_DIR / 'sweep'}"])
    # its ranks are processes of their own: their launches are not this process's
    run("sharded_compare --grid 1024 --devices 2", (), sharded_compare.main,
        ["--grid=1024", "--devices=2", f"--outdir={SCRIPTS_DIR / 'sharded'}"])
    collect_table_exports()
    run("format_table", (), format_table.main,
        [f"--dir={TABLE_DIR}", f"--sizes={','.join(map(str, TABLE_SIZES))}",
         f"--csv={TABLE_DIR / 'spmv_format_table.csv'}",
         f"--write-doc={SCRIPTS_DIR / 'GENERIC_COMPARISON.md'}"])
    rows = format_table.load_rows(TABLE_DIR)
    missing = [(m, g) for m in TABLE_MODES for g in (G_BIG, RUN_ALL_GRID) if (m, g) not in rows]
    if missing:
        raise AssertionError(f"format_table: no cell for {missing}")
    (SCRIPTS_DIR / "chip_smoke_scripts.json").write_text(json.dumps(
        {"big_solve": big, "audit": {g: {k: v for k, v in a.items() if k != "device"}
                                     for g, a in audits.items()},
         "seconds": time.perf_counter() - t_phase}, indent=1))
    print(f"[scripts] phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts.totals()


def _headline_child(metric, counts_path) -> int:
    """A phase-13 headline run, alone in a fresh process: ``headline.main`` for one metric,
    every launch count set to 0 just before it and written, with the share graph replays
    made, to ``counts_path`` just after.  Its stdout is the headline's one line."""
    from tpusparse_torch.bench import headline
    from tpusparse_torch.kernels import blas1, dia, ell
    from tpusparse_torch.kernels import graph as graph_kernels
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg

    counters = (st5, blas1, ell, dia, graph_kernels, cg)
    for c in counters:
        c.reset_launches()
    rc = headline.main([f"--metric={metric}"])
    pathlib.Path(counts_path).write_text(json.dumps(
        {"counts": launch_counts(counters), "replayed": dict(cg.LAUNCHES)}))
    return rc


def run_headline(metric, needs, counts, smi) -> dict:
    """``python -m tpusparse_torch.bench.headline --metric=<metric>``'s work in a fresh
    process (``_headline_child``): rc 0, exactly one JSON line on stdout, its progress
    lines printed here, its launch counts recorded as a path of ``counts``.  Returns the
    line."""
    import subprocess

    HEADLINE_DIR.mkdir(parents=True, exist_ok=True)
    counts_path = HEADLINE_DIR / f"launches_{metric}.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", str(ROOT / "chip_smoke.py"), HEADLINE_CHILD,
                           metric, str(counts_path)], cwd=ROOT, capture_output=True,
                          text=True, timeout=HEADLINE_TIMEOUT)
    wall = time.perf_counter() - t0
    (HEADLINE_DIR / f"{metric}.log").write_text(proc.stdout + proc.stderr)
    for line in proc.stderr.splitlines():
        if line.startswith("[headline]"):
            print(line, flush=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"headline --metric={metric}: rc {proc.returncode}, "
                             f"{len(lines)} stdout lines:\n{proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")
    res = json.loads(lines[0])
    child = json.loads(counts_path.read_text())
    counts.record(f"headline --metric={metric}", needs, child["counts"], child["replayed"])
    print(f"[headline] --metric={metric}: {lines[0]} (the process's wall {wall:.1f} s) "
          f"[{smi}]", flush=True)
    return res


def check_headline_cg(res, results, smi) -> None:
    """The CG line: bench.py's keys and ``device``, 14 iterations, at least
    HEADLINE_MIN_VALID valid runs, the faster loop named, and its median within
    HEADLINE_TOL of phase 5's CLI median of the same solve."""
    missing = [k for k in HEADLINE_KEYS if k not in res]
    loop_ref = HEADLINE_LOOPS.get(res.get("loop"))
    if missing or loop_ref is None:
        raise AssertionError(f"headline cg: keys missing {missing}, loop {res.get('loop')}")
    faster = min(res["value"], res["classic_loop_ms"])
    ref = {label: results[label]["timing"]["total_median_ms"]
           for label in (*HEADLINE_LOOPS.values(), "bf16c f32")}
    off = abs(res["value"] - ref[loop_ref]) / ref[loop_ref]
    print(f"[headline] cg: {res['loop']} median {res['value']!r} ms against phase 5's "
          f"{loop_ref} CLI median {ref[loop_ref]!r} ms ({100 * off:.2f}% apart, tol "
          f"{100 * HEADLINE_TOL:g}%); classic {res['classic_loop_ms']!r} ms against "
          f"{ref['const f32 classic']!r}; bf16c {res['values_carrying_bf16c_ms']!r} ms "
          f"against {ref['bf16c f32']!r}; vs_baseline {res['vs_baseline']!r}, bf16c "
          f"{res['vs_baseline_bf16c']!r}; {res['iterations']} iterations, "
          f"{res['valid_runs']}/{res['total_runs']} valid runs [{smi}]", flush=True)
    if res["iterations"] != 14 or res["valid_runs"] < HEADLINE_MIN_VALID \
            or res["value"] != faster or not off <= HEADLINE_TOL:
        raise AssertionError(f"headline cg: {res}")


def compare_dryrun_shapes(torch, st5, blas1, cmp):
    """K8 (with and without its dot) and K4-K7 against their twins in f64 at the shapes
    ``dryrun_multichip`` gives them on DRYRUN_RANKS shards (seeded random fields and
    planes): each shard's band or 2-D block with exchanged halo rows, K8 in the overlapped
    SpMV's three pieces and over the whole piece; the one-device solves' whole grids (the
    single-device oracle and the one-rank leg) with no halo."""
    from tpusparse_torch import entry

    dev = torch.device("cuda")
    shapes = set()
    for n in DRYRUN_RANKS:
        g, g_large, mesh2 = entry.dryrun_grids(n)
        shapes |= {(g // n, g, True), (g_large // n, g_large, True), (g, g, False),
                   (g_large, g_large, False)}
        if mesh2 is not None:
            shapes.add((g // mesh2[0], g // mesh2[1], True))
    gen = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev, dtype=torch.float64)

    for rows, width, halos in sorted(shapes):
        p, planes = rand(rows, width), rand(5, rows, width)
        if halos:
            hp, hn = rand(1, width), rand(1, width)
            lab = f"dryrun piece {rows}×{width} f64 + halos"
            compare_band_pieces(torch, st5, cmp, planes, p, hp, hn, lab + ", three pieces")
            compare_k8(torch, st5, cmp, planes, p, (hp, hn), lab)
        else:
            lab = f"dryrun one-device grid {rows}×{width} f64"
            compare_k8(torch, st5, cmp, planes, p, (), lab)
        compare_blas1(torch, blas1, cmp, p, *(rand(rows, width) for _ in range(3)), lab)


def phase_entry(torch, counters, results, cmp, smi):
    """Phase 13: the top-level entry points, each from its own launch counts.  The headline
    benchmark's two metrics, each in a fresh process (``run_headline``), and K8 against
    its twin on the SpMV metric's inputs (``headline.spmv_inputs``, f32); ``entry()``'s
    forward, K8 with its dot at 256², held to the plain twin on its x = ones and on a
    random x (f32: y 1e-5, the dot 1e-4); ``dryrun_multichip`` on meshes of 2 and 4 shards
    sharing the card (f64, exact parity), each recorded as a path, its shards' K8 launches
    taking exchanged halo rows, and its kernels against their twins at its shapes
    (``compare_dryrun_shapes``).  Returns {wrapper: launches summed over its paths}."""
    from tpusparse_torch import entry
    from tpusparse_torch.bench import headline
    from tpusparse_torch.kernels import blas1
    from tpusparse_torch.kernels import stencil5 as st5

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counts = PathCounts(counters)
    lines = {metric: run_headline(metric, needs, counts, smi)
             for metric, needs in HEADLINE_RUNS.items()}
    check_headline_cg(lines["cg"], results, smi)
    spmv = lines["spmv"]
    print(f"[headline] spmv: K8 {spmv['grid']}² f32 {spmv['ms_per_apply']!r} ms an apply, "
          f"{spmv['value']!r} of the HBM peak (at most {SPMV_MAX_FRACTION:g}), vs_baseline "
          f"{spmv['vs_baseline']!r} [{smi}]", flush=True)
    if not 0 < spmv["value"] <= SPMV_MAX_FRACTION:
        raise AssertionError(f"headline spmv: {spmv}")
    planes, x = headline.spmv_inputs(spmv["grid"], torch.device("cuda"))
    compare_k8(torch, st5, cmp, planes, x, (),
               f"headline --metric=spmv inputs {spmv['grid']}² f32, x from seed 0")
    del planes, x
    torch.cuda.empty_cache()

    def forward():
        fwd, (planes, x) = entry.entry()
        return fwd, planes, x, fwd(planes, x)

    fwd, planes, x, out = counts.run("entry()", ("spmv_stencil5",), forward)
    xr = torch.randn(x.shape, generator=torch.Generator(x.device).manual_seed(3),
                     device=x.device)
    for what, xin, (y, dot) in (("x = ones", x, out), ("random x", xr, fwd(planes, xr))):
        y_ref, dot_ref = st5.spmv_stencil5_plain(planes, xin, with_dot=True)
        cmp.check("spmv_stencil5", f"entry() {entry.ENTRY_GRID}² f32, {what}", torch.float32,
                  [("y", y, y_ref, "field"), ("dot", dot, dot_ref, "dot")])
    del planes, x, xr, out, y, dot
    compare_dryrun_shapes(torch, st5, blas1, cmp)

    for n in DRYRUN_RANKS:
        t0 = time.perf_counter()
        res = counts.run(f"dryrun_multichip({n}) in this process", DRYRUN_NEEDS,
                         lambda n=n: entry.dryrun_multichip(n))
        halo = res["halo_calls"]
        if not 0 < halo["exchange"] <= halo["spmv_stencil5"] \
                <= res["launches"].get("spmv_stencil5", 0):
            raise AssertionError(f"dryrun_multichip({n}): launches {res['launches']}, halo "
                                 f"counts {halo}: its shards' K8 never took exchanged rows")
        print(f"[dryrun] n={n}: {res['iterations']} iterations at {res['grid']}², "
              f"{res['large_iterations']} at {res['large_grid']}², f64, parity exact; "
              f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    (HEADLINE_DIR / "launches.json").write_text(json.dumps(counts.by_path, indent=1))
    print(f"[entry] phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts.totals()


def mesh_per_iteration(shape, mode, stepped):
    """({wrapper: launches}, {HALO_CALLS name: count}) of one iteration of a mesh run over
    all its shards (bands of 3 rows or more: the classic SpMV in three row pieces); the
    stepped loop's launches are eager, and also launch K6 for <p, A·p> (``mesh_launches``)."""
    from tpusparse_torch.solvers import cg_sharded

    n = 1
    for v in shape:
        n *= v
    nr, nc = shape if len(shape) == 2 else (shape[0], 1)
    halo = dict.fromkeys(cg_sharded.HALO_CALLS, 0)
    if mode == "stencil5-const" and len(shape) == 1 and not stepped:
        passes = ("spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute")
        halo.update({"exchange": n, **dict.fromkeys(passes, n)} if n > 1 else {})
        return dict.fromkeys(passes, n), halo
    spmv = {"stencil5": "spmv_stencil5", "stencil5-const": "spmv_stencil5_const",
            "csr": "spmv_ell"}[mode]
    sides = nr * (2 * nc - 2)  # the blocks' side columns that have a neighbour
    launches = {spmv: (1 if mode == "csr" else 3) * n, "cg_update": n, "p_update": n}
    if sides and not stepped:  # each side column's term of <p, A·p> (K6)
        launches["dot"] = sides
    if nr > 1:
        halo["exchange"] = n
        halo[spmv] = n if mode == "csr" else nc * (2 * nr - 2)
    if nc > 1:
        halo["column_exchange"], halo["column_correction"] = n, sides
    return launches, halo


def mesh_launches(per, n, k, stepped):
    """{wrapper: launches} of a mesh run's MESH_SOLVES solves of k iterations on n shards:
    the graph loop's replays (``per`` k times a solve, the condition kernel once and twice
    a body) and each solve's <r0, r0> (K6, eager, a shard); the stepped loop's eager
    launches (no K5 after the last iteration, K6 for <r0, r0> and each <p, A·p>)."""
    solves = MESH_SOLVES
    if stepped:
        want = {w: v * k * solves for w, v in per.items()}
        want["p_update"] = per["p_update"] * (k - 1) * solves
        want["dot"] = n * (k + 1) * solves
        return want
    want = {w: v * k * solves for w, v in per.items()}
    want["dot"] = want.get("dot", 0) + n * solves
    want[COND] = solves * (1 + 2 * -(-k // 2))
    return want


def _mesh_x_rank(device, grid, cases):
    """One gloo rank of the phase-14 parity check (spawned by dist.launch_local): each
    case solved at ``grid``², the solution gathered; rank 0 returns {label: (x, k)}."""
    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    out = {}
    for label, (_n, blocks, mode, dtype, kw) in cases.items():
        solve_kw = dict(mode=mode, dtype=getattr(torch, dtype), device=device)
        if blocks is not None:
            x, s = cg_sharded.cg_solve_sharded_2d(blocks, grid, **solve_kw)
            x = dist.gather_blocks_to_host(x, blocks)
        else:
            solve = (cg_sharded.cg_solve_sharded_stepped if kw.get("stepped")
                     else cg_sharded.cg_solve_sharded)
            x, s = solve(grid, **solve_kw)
            x = dist.gather_to_host(x, rows=grid)
        out[label] = (x, s.iterations)
        cg_sharded.clear_caches()
    return out if dist.rank() == 0 else None


def check_mesh_x(torch, smi, gloo_by_n):
    """The mesh's x against the gloo ranks' bit for bit at MESH_X_GRID² in every case of
    MESH_X_CASES (``gloo_by_n``: {ranks: {label: (x, iterations)}}, what phase 9's group
    of ranks sharing the card ran for a shard count)."""
    from tpusparse_torch import dist
    from tpusparse_torch._device import host_numpy
    from tpusparse_torch.solvers import cg_sharded

    for n, gloo in gloo_by_n.items():
        t0 = time.perf_counter()
        cases = {label: c for label, c in MESH_X_CASES.items() if c[0] == n}
        for label, (_n, blocks, mode, dtype, kw) in cases.items():
            solve_kw = dict(mode=mode, dtype=getattr(torch, dtype))
            if blocks is not None:
                x, s = cg_sharded.cg_solve_sharded_2d(dist.make_mesh(blocks), MESH_X_GRID,
                                                      **solve_kw)
            else:
                solve = (cg_sharded.cg_solve_sharded_stepped if kw.get("stepped")
                         else cg_sharded.cg_solve_sharded)
                x, s = solve(MESH_X_GRID, mesh=dist.make_band_mesh(n), **solve_kw)
            x = host_numpy(x)
            cg_sharded.clear_caches()
            xg, its = gloo[label]
            same = s.iterations == its and x.dtype == xg.dtype and bool((x == xg).all())
            print(f"[mesh] x at {MESH_X_GRID}² {label}: {s.iterations} iterations (gloo "
                  f"{its}), x bit for bit the gloo ranks': {same}", flush=True)
            if not same:
                raise AssertionError(f"mesh {label} at {MESH_X_GRID}²: x differs from the "
                                     f"gloo ranks' ({s.iterations} vs {its} iterations)")
        print(f"[mesh] {n} shards against {n} gloo ranks at {MESH_X_GRID}²: the mesh's "
              f"solves {time.perf_counter() - t0:.1f} s (the ranks ran in phase 9) [{smi}]",
              flush=True)


def time_transport(torch, smi):
    """The mesh's transport on the card, each in a CUDA graph of TRANSPORT_REPS, timed with
    CUDA events over 10 replays: a halo exchange and an ordered sum of the shards' partials
    on 2 and 4 bands and a 2 x 2 mesh at G_BIG² f64.  Returns {label: µs}."""
    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    out = {}
    for shape in ((2,), (4,), (2, 2)):
        op = cg_sharded.make_mesh_operator(G_BIG, dist.make_mesh(shape, ("x", "y")[:len(shape)]),
                                           mode="stencil5-const", dtype=torch.float64)
        fields = [sh.p_buffer() for sh in op.shards]
        parts = [torch.ones((), dtype=torch.float64, device="cuda") for _ in op.shards]
        for what, fn in (("halo exchange", lambda: op.exchange(fields)),
                         ("ordered sum", lambda: op.sum(parts))):
            fn()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(TRANSPORT_REPS):
                    fn()
            g.replay()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                g.replay()
            e1.record()
            torch.cuda.synchronize()
            us = e0.elapsed_time(e1) * 1e3 / (10 * TRANSPORT_REPS)
            label = f"{what} {'x'.join(map(str, shape))}"
            out[label] = us
            print(f"[mesh] {label} at {G_BIG}² f64: {us!r} µs each on the device [{smi}]",
                  flush=True)
            del g
        del op, fields
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
    return out


def compare_mesh_shapes(torch, st5, blas1, ell, generate, cmp):
    """The kernels phase 14's mesh drives, against their twins at the shard shapes phase 6
    does not hold them at (seeded random fields): K4-K7 on the bands of 2 and 4 shards
    and the 2 x 2 block in f32, f64 and bf16, K6 on a block's side column (its term of
    <p, A·p>), K1 and K2 on the 2-shard band with halo rows (f32, f64), and the ELL
    kernel's rectangular call over the 2-shard band's gather domain (f64)."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=dev, dtype=dtype)

        for label, (rows, width) in (("2-shard band", (G_BIG // 2, G_BIG)),
                                     ("4-shard band", (G_BIG // 4, G_BIG)),
                                     ("2x2 block", (G_BIG // 2, G_BIG // 2))):
            lab = f"mesh {label} {rows}×{width} {dname(dtype)}"
            fields = [rand(rows, width) for _ in range(4)]
            compare_blas1(torch, blas1, cmp, *fields, lab)
            if label == "2x2 block":
                col, term = rand(rows), rand(rows)
                cmp.check("dot", f"{lab} side column", dtype,
                          [("<p[:, 0], W h_w>", blas1.dot(col, term),
                            blas1.dot_plain(col, term), "dot")])
            if label == "2-shard band" and dtype != torch.bfloat16:  # no bf16 K1, K2
                p, r, x = fields[:3]
                hp, hn = rand(1, width), rand(1, width)
                s = torch.tensor(0.37, dtype=dtype, device=dev)
                pk, dk = st5.spmv_stencil5_const_pupdate_dot(s, r, p, hp, hn,
                                                             out=torch.empty_like(p), **kw)
                pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, hp, hn, **kw)
                cmp.check("spmv_stencil5_const_pupdate_dot", f"{lab} + halos", dtype,
                          [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])
                del pk, pp
                xk, rk, dk = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p, hp, hn,
                                                           **kw)
                xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p,
                                                                 hp, hn, **kw)
                cmp.check("cg_const_update_recompute", f"{lab} + halos", dtype,
                          [("x'", xk, xp, "field"), ("r'", rk, rp, "field"),
                           ("<r',r'>", dk, dp, "dot")])
                del xk, rk, xp, rp
            if label == "2-shard band" and dtype == torch.float64:
                vals, cols = ell_band(torch, generate, G_BIG, 0, rows, dtype)
                dom = rand((rows + 2) * G_BIG)
                y, d = ell.spmv_ell(vals, cols, dom, with_dot=True, dot_offset=G_BIG)
                yp, dp = ell.spmv_ell_plain(vals, cols, dom, with_dot=True, dot_offset=G_BIG)
                cmp.check("spmv_ell", f"{lab} over its gather domain", dtype,
                          [("y", y, yp, "exact"), ("dot", d, dp, "dot")])
                del vals, cols, dom, y, yp
            del fields
            torch.cuda.empty_cache()


def profile_mesh(torch, summary, splits, smi):
    """One solve of each MESH_PROFILED run under torch.profiler after a solve that captures
    its graph: its device time by kernel group beside phase 7's split of the single-device
    solve (``splits``) and its idle share against the run's median (``summary``); tables
    to chiprun_out/profile_mesh.txt.  Returns {label: {kernel group: device ms}}."""
    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    tables, out = [], {}
    for label, single in MESH_PROFILED.items():
        shape, extra, _loop, _ref, _gloo = MESH_RUNS[label]
        mode, dtype = (a.split("=")[1] for a in extra[:2])
        op = cg_sharded.make_mesh_operator(
            G_BIG, dist.make_mesh(shape, ("x", "y")[:len(shape)]), mode=mode,
            dtype={"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dtype])
        op.solve()  # the capture
        torch.cuda.synchronize()
        out[label] = profile_split(torch, op.solve, f"{label} {G_BIG}²",
                                   summary[label]["median_ms"], "phase 14's", tables, smi)
        print(f"[profile] {label} beside one device's {single} (phase 7): " + ", ".join(
            f"{g} {out[label].get(g, 0.0)!r} / {splits[single].get(g, 0.0)!r} ms"
            for g in dict.fromkeys([*out[label], *splits[single]])) + f" [{smi}]", flush=True)
        del op
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
    (OUT / "profile_mesh.txt").write_text("\n\n".join(tables))
    return out


def phase_mesh(torch, counters, results, cmp, smi, splits, gloo_by_n):
    """Phase 14: the multichip CLI without a process group, so this process drives a mesh
    of shards sharing the card (cg_sharded.MeshOperator), each run of MESH_RUNS at G_BIG²
    uncut from its own launch counts: 14 iterations (a bf16 state: any), Sum/Norm2 against
    phase 5's single-device solve (MESH_TOL) and bit for bit against the phase 9/10 gloo run
    of the same decomposition, every shard on the card, one replay and one read a solve
    (the stepped loop: none), and its launches and halo counts exactly those its iterations
    make (``mesh_per_iteration``: the graph's replays through ``_launch.count_replay``).
    Then a few of those solves profiled beside phase 7's single-device ones
    (``profile_mesh``; ``splits``: phase 7's), the mesh's x against the gloo ranks' bit
    for bit at MESH_X_GRID² (``check_mesh_x``; ``gloo_by_n``: phase 9's ranks' solves),
    the transport's device time (``time_transport``) and the kernels at the shard shapes
    (``compare_mesh_shapes``).  Returns {wrapper: launches summed over the runs}."""
    from tpusparse_torch import generate
    from tpusparse_torch.cli import cg_solver_multichip
    from tpusparse_torch.kernels import blas1, ell
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg, cg_sharded

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counts = PathCounts(counters)
    card = torch.cuda.get_device_name(0)
    summary = {}
    for label, (shape, extra, loop, ref_label, gloo_label) in MESH_RUNS.items():
        n = shape[0] * (shape[1] if len(shape) == 2 else 1)
        slug = re.sub(r"[^a-z0-9]+", "_", label)
        path = OUT / f"chip_smoke_{slug}.json"
        split = [f"--mesh2d={shape[0]}x{shape[1]}"] if len(shape) == 2 else [f"--chips={n}"]
        mode = extra[0].removeprefix("--mode=")
        stepped = loop == "host-stepped"
        per, halo_per = mesh_per_iteration(shape, mode, stepped)
        cg.reset_counts()
        cg_sharded.reset_halo_calls()
        t0 = time.perf_counter()
        rc = counts.run(label, tuple(per), lambda: cg_solver_multichip.main(
            [f"gen:{G_BIG}", *extra, *split, *MESH_ARGS, f"--json={path}"]))
        wall = time.perf_counter() - t0
        reads, halo = reads_of(cg.COUNTS), dict(cg_sharded.HALO_CALLS)
        res = json.loads(path.read_text())
        its, dtype, topo = res["convergence"]["iterations"], res["dtype"], res["topology"]
        if rc != 0 or res["loop"] != loop or (its != 14 and dtype != "bf16"):
            raise AssertionError(f"{label}: rc {rc}, loop {res['loop']}, {its} iterations")
        if topo["transport"] != "mesh" or topo["num_processes"] != 1 \
                or topo["devices"] != ["cuda:0"] * n or topo["device_kinds"] != [card]:
            raise AssertionError(f"{label}: a shard off the card: {topo}")
        want = mesh_launches(per, n, its, stepped)
        got = {k: v for k, v in counts.by_path[label].items() if v}
        want_reads = ({"host_reads": 0, "replays": 0} if stepped
                      else {"host_reads": MESH_SOLVES, "replays": MESH_SOLVES})
        want_halo = {k: v * its * MESH_SOLVES for k, v in halo_per.items()}
        if got != want or reads != want_reads or halo != want_halo:
            raise AssertionError(f"{label}: launches {got} (want {want}), reads {reads} (want "
                                 f"{want_reads}), halo counts {halo} (want {want_halo})")
        ref = results[ref_label]["validation"]
        errs = {k: abs(res["validation"][k] - ref[k]) / abs(ref[k])
                for k in ("solution_sum", "solution_norm")}
        if not max(errs.values()) <= MESH_TOL[dtype]:
            raise AssertionError(f"{label}: Sum/Norm2 against {ref_label}: {errs}")
        single_label = "stencil5 bf16" if dtype == "bf16" else ref_label
        t, single = res["timing"], results[single_label]["timing"]["total_median_ms"]
        line = (f"[mesh] {label}: {its} iterations, median {t['total_median_ms']!r} ms "
                f"(single device {single!r} ms, {single_label})")
        gloo_ms = None
        if gloo_label is not None:
            gloo = json.loads((OUT / f"chip_smoke_{re.sub(r'[^a-z0-9]+', '_', gloo_label)}"
                                     f".json").read_text())
            if gloo["validation"] != res["validation"] \
                    or gloo["convergence"]["iterations"] != its:
                raise AssertionError(f"{label}: Sum/Norm2 {res['validation']} are not the "
                                     f"gloo run's {gloo['validation']} ({gloo_label})")
            gloo_ms = gloo["timing"]["total_median_ms"]
            line += f", gloo {gloo_ms!r} ms ({gloo_label}; Sum/Norm2 bit for bit)"
        line += (f"; Sum rel {errs['solution_sum']:.3e}, Norm2 rel {errs['solution_norm']:.3e} "
                 f"(tol {MESH_TOL[dtype]:g}); {reads['host_reads']} reads, "
                 f"{reads['replays']} replays in {MESH_SOLVES} solves; assembly "
                 f"{t['allgather_ms']!r} ms; the run's wall {wall:.1f} s [{smi}]")
        print(line, flush=True)
        if stepped:
            buckets = {k: t[f"{k}_ms"] for k in ("halo", "spmv", "allreduce", "blas1")}
            print(f"[mesh] {label} buckets: " + ", ".join(f"{k} {v!r} ms"
                                                          for k, v in buckets.items())
                  + f"; sum {sum(buckets.values())!r} of the median {t['total_median_ms']!r}"
                  f" ms [{smi}]", flush=True)
            if not (min(buckets.values()) > 0
                    and sum(buckets.values()) <= t["total_median_ms"]):
                raise AssertionError(f"{label}: buckets {buckets}")
        summary[label] = {"median_ms": t["total_median_ms"], "single_device": single_label,
                          "single_device_ms": single,
                          "gloo_ms": gloo_ms, "iterations": its, "reads": reads,
                          "assembly_ms": t["allgather_ms"], "launches": got}
        torch.cuda.empty_cache()
    summary["profiles"] = profile_mesh(torch, summary, splits, smi)
    check_mesh_x(torch, smi, gloo_by_n)
    summary["transport_us"] = time_transport(torch, smi)
    compare_mesh_shapes(torch, st5, blas1, ell, generate, cmp)
    summary["card"] = smi
    (OUT / "chip_smoke_mesh.json").write_text(json.dumps(summary, indent=1))
    print(f"[mesh] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts.totals()


def reads_of(counts):
    """The host reads and the replays of a ``cg.COUNTS``: what the checks compare (its
    solves and captures are the spans' counters)."""
    return {k: counts[k] for k in ("host_reads", "replays")}


def uncounted(fn):
    """fn() with every count put back as it was: the wrappers' launches, the graph
    replays' launches, the host reads and replays, the halo counts (a solve run beside a
    path, not on it)."""
    from tpusparse_torch.kernels import _launch
    from tpusparse_torch.solvers import cg, cg_sharded

    replayed, reads, halo = dict(_launch.REPLAYED), dict(cg.COUNTS), dict(cg_sharded.HALO_CALLS)
    with _launch.set_apart():
        out = fn()
    _launch.REPLAYED.clear()
    _launch.REPLAYED.update(replayed)
    cg.COUNTS.update(reads)
    cg_sharded.HALO_CALLS.update(halo)
    return out


def card_launches(shape, mode, k, solves, cards=1):
    """{wrapper: launches} of ``solves`` per-card solves of k iterations on ``cards``
    cards: the mesh's kernels (``mesh_per_iteration``, <r0, r0> a shard), the condition
    kernel once before each card's WHILE node and twice a body, and the sync kernels (a
    shard's rows with more than one shard, its two partials, a wait at each)."""
    per, _halo = mesh_per_iteration(shape, mode, False)
    n = 1
    for v in shape:
        n *= v
    rows = n > 1
    want = {w: v * k * solves for w, v in per.items()}
    want["dot"] = want.get("dot", 0) + n * solves
    want[COND] = cards * solves * (1 + 2 * -(-k // 2))
    want.update({"mesh_publish_rows": n * k * rows * solves,
                 "mesh_publish_partial": 2 * n * k * solves,
                 "mesh_wait": (2 + rows) * n * k * solves})
    return {w: v for w, v in want.items() if v}


def compare_sync(torch, smi):
    """The sync kernels against their twins (the same calls on CPU copies, everything
    compared bit for bit): at 2 and 4 shards, f64, f32 and bf16 rows, a G_BIG-wide row and
    a G_BIG/2-long strided column (a 2 x 2 block's) into a neighbour's halo buffers, a
    partial into every shard's slots, the wait on the rows' flags and the wait that sums
    the slots, and a wait that passes its bound (its code, NaN).  Then each timed in a
    CUDA graph of SYNC_REPS launches (f64, 4 shards), beside its twin's host time and its
    byte bound.  Returns {wrapper: its kernels line entry}."""
    from tpusparse_torch.kernels import mesh_sync

    def case(t, n):
        """The calls on the inputs ``t`` (on the card or the CPU), for n shards."""
        device, acc = t["row_src"].device, t["slots"].dtype
        row, col = torch.zeros_like(t["row_src"]), torch.zeros_like(t["block"][:, -1])
        ctl = torch.tensor([40 + n, 0], dtype=torch.int64, device=device)
        flags = torch.zeros((n, 4 + n), dtype=torch.int64, device=device)
        slots = t["slots"][:n, :n].clone()
        mesh_sync.publish_rows(ctl, mesh_sync.row_links(
            [(t["row_src"], row, flags[1, 0]), (t["block"][:, -1], col, flags[1, 2])],
            device))
        mesh_sync.publish_partial(ctl, t["part"], mesh_sync.partial_links(
            [(slots[j, 0], flags[j, 4]) for j in range(n)], device))
        flags[:, 5:].fill_(41 + n)
        mesh_sync.wait(ctl, flags[1, :4], 0b0101, 99, 10 ** 9)
        ctl[0] = 40 + n
        out = torch.empty((), dtype=acc, device=device)
        mesh_sync.wait(ctl, flags[0, 4:], (1 << n) - 1, 98, 10 ** 9, slots=slots[0], out=out)
        late = torch.zeros(2, dtype=torch.int64, device=device)
        nan = torch.empty((), dtype=acc, device=device)
        mesh_sync.wait(late, flags[1, :4], 0b0010, 97, 0 if device.type == "cpu" else 1000)
        mesh_sync.wait(late, flags[1, 4:], 1, 96, 1000, slots=slots[1], out=nan)
        return {"mesh_publish_rows": (row, col, flags[1, :4]),
                "mesh_publish_partial": (slots[:, 0], flags[:, 4]),
                "mesh_wait": (out, ctl, late, torch.nan_to_num(nan, nan=7.0))}

    err = dict.fromkeys(mesh_sync.LAUNCHES, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(15)
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        acc = torch.float32 if dtype == torch.bfloat16 else dtype
        cuda = {"row_src": torch.randn(G_BIG, generator=gen, device="cuda").to(dtype),
                "block": torch.randn((G_BIG // 2, G_BIG // 2), generator=gen,
                                     device="cuda").to(dtype),
                "slots": torch.randn((4, 4), generator=gen, device="cuda").to(acc),
                "part": torch.randn((), generator=gen, device="cuda").to(acc)}
        host = {k: v.cpu() for k, v in cuda.items()}
        for n in (2, 4):
            got, want = case(cuda, n), case(host, n)
            torch.cuda.synchronize()
            for name, pairs in want.items():
                for k, p in zip(got[name], pairs):
                    err[name] = max(err[name], abs_err(k.cpu(), p))
                    if not torch.equal(k.cpu(), p):
                        raise AssertionError(f"{name} {n} shards {dname(dtype)}: the kernel's "
                                             f"{tuple(p.shape)} differs from its twin's")
            print(f"[compare] sync {n} shards {dname(dtype)}: a {G_BIG}-wide row, a "
                  f"{G_BIG // 2}-long column {G_BIG // 2} apart, the partials, both waits and "
                  f"a wait past its bound equal their twins bit for bit", flush=True)
        del cuda, host
    n, f64 = 4, torch.float64
    block = torch.rand((G_BIG // 2, G_BIG), dtype=f64, device="cuda")
    row, col = torch.zeros(G_BIG, dtype=f64, device="cuda"), torch.zeros(G_BIG // 2, dtype=f64,
                                                                          device="cuda")
    ctl = torch.zeros(2, dtype=torch.int64, device="cuda")
    flags = torch.full((n, 4 + n), 1 << 62, dtype=torch.int64, device="cuda")
    slots, out = torch.rand((n, n), dtype=f64, device="cuda"), torch.empty((), dtype=f64,
                                                                             device="cuda")
    part = torch.rand((), dtype=f64, device="cuda")
    links = mesh_sync.row_links([(block[-1], row, flags[1, 0]), (block[:, -1], col,
                                                                  flags[1, 2])], "cuda")
    dests = mesh_sync.partial_links([(slots[j, 0], flags[j, 4]) for j in range(n)], "cuda")
    calls = {
        "mesh_publish_rows": (lambda: mesh_sync.publish_rows(ctl, links),
                              (2 * nbytes(row, col), 0)),
        "mesh_publish_partial": (lambda: mesh_sync.publish_partial(ctl, part, dests),
                                 (nbytes(part) + n * (8 + 8), 0)),
        "mesh_wait": (lambda: mesh_sync.wait(ctl, flags[0, 4:], (1 << n) - 1, 98, 10 ** 9,
                                             slots=slots[0], out=out),
                      (nbytes(flags[0, 4:], slots[0], out) + 2 * 8, 0)),
        "mesh_wait rows": (lambda: mesh_sync.wait(ctl, flags[1, :4], 0b0101, 99, 10 ** 9),
                           (2 * 8 + 2 * 8, 0)),
    }
    cpu = {"ctl": ctl.cpu(), "flags": flags.cpu(), "slots": slots.cpu(), "out": out.cpu(),
           "part": part.cpu(), "block": block.cpu(), "row": row.cpu(), "col": col.cpu()}
    cpu_links = mesh_sync.row_links([(cpu["block"][-1], cpu["row"], cpu["flags"][1, 0]),
                                     (cpu["block"][:, -1], cpu["col"], cpu["flags"][1, 2])],
                                    "cpu")
    cpu_dests = mesh_sync.partial_links([(cpu["slots"][j, 0], cpu["flags"][j, 4])
                                         for j in range(n)], "cpu")
    twins = {
        "mesh_publish_rows": lambda: mesh_sync.publish_rows(cpu["ctl"], cpu_links),
        "mesh_publish_partial": lambda: mesh_sync.publish_partial(cpu["ctl"], cpu["part"],
                                                                  cpu_dests),
        "mesh_wait": lambda: mesh_sync.wait(cpu["ctl"].zero_(), cpu["flags"][0, 4:],
                                            (1 << n) - 1, 98, 10 ** 9, slots=cpu["slots"][0],
                                            out=cpu["out"]),
        "mesh_wait rows": lambda: mesh_sync.wait(cpu["ctl"].zero_(), cpu["flags"][1, :4],
                                                 0b0101, 99, 10 ** 9),
    }
    entries = {}
    for name, (fn, work) in calls.items():
        fn()
        if name.startswith("mesh_wait"):  # every wait finds its flags there (the twin's
            flags.fill_(1 << 62)          # at epoch 1, its epoch set back to 0 each call)
            cpu["flags"].fill_(1)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(SYNC_REPS):
                fn()
        us = _time_ms(torch, g.replay) * 1e3 / SYNC_REPS
        del g
        t0 = time.perf_counter()
        for _ in range(SYNC_REPS):
            twins[name]()
        plain_ms = (time.perf_counter() - t0) * 1e3 / SYNC_REPS
        bound_ms, bound_by = bound(work, "f64")
        print(f"[time] sync {name} f64, {n} shards: {us!r} µs a launch in a graph of "
              f"{SYNC_REPS}, twin {plain_ms * 1e3!r} µs on the host, bound {bound_ms * 1e3!r} "
              f"µs ({bound_by}) [{smi}]", flush=True)
        entries[name] = {"max_abs_err": err.get(name, 0.0), "max_rel_err": 0.0,
                         "ms": us / 1e3, "plain_ms": plain_ms, "library_ms": None,
                         "bound_ms": bound_ms, "bound_by": bound_by}
    if int(ctl[1].item()) or any(torch.isnan(out).reshape(1).tolist()):
        raise AssertionError("a timed sync kernel took its error path")
    entries["mesh_wait"]["rows_wait_ms"] = entries.pop("mesh_wait rows")["ms"]
    return entries


def _withheld_child(bound_s) -> int:
    """A per-card loop of 2 shards on the card with shard 1 left out of its graph: prints
    {"error": ..., "seconds": ..., "iterations": [before, after]} (the solve's
    RuntimeError, its wall time, and the iterations of a solve before it and of one by a
    new loop after it)."""
    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    cg_sharded.WAIT_BOUND_S = float(bound_s)
    op = cg_sharded.make_mesh_operator(WITHHELD_GRID, dist.make_band_mesh(2), mode="stencil5",
                                       dtype=torch.float64)
    _xs, before = op.solve(per_shard=True)
    loop = next(lp for lp in op.graphs.values() if isinstance(lp, cg_sharded.CardLoop))
    loop.withheld = 1
    t0 = time.perf_counter()
    try:
        op.solve(per_shard=True)
        error = None
    except RuntimeError as e:
        error = str(e)
    seconds = time.perf_counter() - t0
    _xs, after = op.solve(per_shard=True)
    print(json.dumps({"error": error, "seconds": seconds,
                      "iterations": [before.iterations, after.iterations]}))
    return 0


def run_withheld(smi):
    """The withheld-shard child (a process of its own: its waits spin until the bound):
    shard 0's wait must give up within [bound, bound + 5 s] and the solve raise, and a new
    loop must then solve in as many iterations as before.  Returns its record."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), WITHHELD_CHILD,
                          str(WITHHELD_BOUND_S)], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    if out.returncode != 0:
        raise AssertionError(f"the withheld-shard child failed ({out.returncode}):\n"
                             f"{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    its = res["iterations"]
    ok = (res["error"] is not None and "shard 0's wait" in res["error"]
          and WITHHELD_BOUND_S <= res["seconds"] < WITHHELD_BOUND_S + 5
          and its[0] == its[1] > 0)
    print(f"[cards] withheld shard 1 of 2 at {WITHHELD_GRID}²: the solve raised after "
          f"{res['seconds']:.3f} s (bound {WITHHELD_BOUND_S:g} s): {res['error']!r}; "
          f"{its[0]} iterations before, {its[1]} by a new loop after; the child's wall "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    if not ok:
        raise AssertionError(f"withheld shard: {res}")
    return res


def _profiled_child() -> int:
    """A torch.profiler session begun before the kernels load (nothing of the port has
    launched in this process), then the per-card loop on PROFILED_SHARDS shards sharing
    cuda:0 at WITHHELD_GRID² f64, one graph for the card; after the session the mesh's
    one graph on the same operator.  Prints {"iterations": [per card,
    mesh], "same": x bit for bit, "seconds": the per-card solve's wall, capture included,
    "wait_records": the profile's records of the wait kernel}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    mesh = dist.make_mesh((PROFILED_SHARDS,), ("x",), devices=["cuda:0"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        op = cg_sharded.make_mesh_operator(WITHHELD_GRID, mesh, mode="stencil5",
                                           dtype=torch.float64)
        xs, s = op.solve(per_shard=True)
        seconds = time.perf_counter() - t0
    waits = sum(e.count for e in prof.key_averages() if "wait_kernel" in e.key)
    xs_m, s_m = op.solve()
    print(json.dumps({"iterations": [s.iterations, s_m.iterations], "seconds": seconds,
                      "same": all(torch.equal(a, b) for a, b in zip(xs, xs_m)),
                      "wait_records": waits}))
    return 0


def run_profiled(smi):
    """The profiled child (a process of its own, killed after PROFILED_TIMEOUT_S): its
    per-card solve must end, x bit for bit the mesh's in as many iterations.  Returns its
    record."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), PROFILED_CHILD],
                         cwd=ROOT, capture_output=True, text=True, timeout=PROFILED_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"the profiled child failed ({out.returncode}):\n"
                             f"{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    its = res["iterations"]
    print(f"[cards] profiler begun before the kernels load, {PROFILED_SHARDS} shards sharing "
          f"the card at {WITHHELD_GRID}²: the per-card solve ended in {its[0]} iterations "
          f"(mesh {its[1]}), x bit for bit the mesh's: {res['same']}; {res['seconds']:.3f} s "
          f"with its capture, {res['wait_records']} wait-kernel records in the profile; the "
          f"child's wall {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    if not (res["same"] and its[0] == its[1] > 0):
        raise AssertionError(f"profiled child: {res}")
    return res


def phase_cards(torch, counters, smi):
    """Phase 15: the per-card loop (cg_sharded.CardLoop, ``per_shard=True``), a graph a
    card, its shards sharing the card, against the mesh's one graph (MeshLoop) at G_BIG²
    in every case of CARD_RUNS: a first solve of each loop, then CARD_TIMED rounds in
    turns; the per-card solves are the path (counts set to 0 before, read after; the
    mesh's solves beside it uncounted): its x bit for bit the mesh's, 14 iterations (bf16:
    the mesh's), one read and one replay a card a solve, and exactly the launches its
    iterations make (``card_launches``).  Then the sync kernels against their twins and
    timed (``compare_sync``), the withheld-shard child (``run_withheld``) and the
    profiled child (``run_profiled``).  Returns ({wrapper: launches summed over the
    runs}, {sync wrapper: its kernels line entry})."""
    from tpusparse_torch import dist
    from tpusparse_torch.kernels import mesh_sync
    from tpusparse_torch.solvers import cg, cg_sharded

    t_phase = time.perf_counter()
    counts = PathCounts((*counters, mesh_sync))
    summary = {}
    for label, (shape, mode, dtype_name, kw) in CARD_RUNS.items():
        t0 = time.perf_counter()
        n = 1
        for v in shape:
            n *= v
        op = cg_sharded.make_mesh_operator(
            G_BIG, dist.make_mesh(shape, ("x", "y")[:len(shape)]), mode=mode,
            dtype=getattr(torch, dtype_name))
        times = {"mesh": [], "cards": []}

        def timed(name, **solve_kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            xs, s = op.solve(**solve_kw, **kw)
            times[name].append((time.perf_counter() - t) * 1e3)
            return xs, s

        xs_m, s_m = uncounted(lambda: op.solve(**kw))
        x_m = [x.clone() for x in xs_m]
        del xs_m
        first = {}

        def path():
            cg.reset_counts()
            xs, s = op.solve(per_shard=True, **kw)
            first["same"] = all(torch.equal(a, b) for a, b in zip(xs, x_m))
            first["iterations"] = s.iterations
            del xs
            for r in range(CARD_TIMED):
                for name in (("mesh", "cards") if r % 2 == 0 else ("cards", "mesh")):
                    if name == "mesh":
                        uncounted(lambda: timed("mesh"))
                    else:
                        timed("cards", per_shard=True)
            return reads_of(cg.COUNTS)

        cards = len(set(op.mesh.devices))
        needs = tuple(card_launches(shape, mode, 1, 1))
        reads = counts.run(f"cards {label}", needs, path)
        k, solves = first["iterations"], 1 + CARD_TIMED
        want = card_launches(shape, mode, k, solves, cards)
        got = {w: v for w, v in counts.by_path[f"cards {label}"].items() if v}
        want_reads = {"host_reads": solves, "replays": cards * solves}
        its_ok = k == s_m.iterations and (k == 14 or dtype_name == "bfloat16")
        if not (first["same"] and its_ok and got == want and reads == want_reads):
            raise AssertionError(f"cards {label}: x bit for bit {first['same']}, iterations "
                                 f"{k} (mesh {s_m.iterations}), launches {got} (want {want}), "
                                 f"reads {reads} (want {want_reads})")
        med = {name: sorted(v)[len(v) // 2] for name, v in times.items()}
        print(f"[cards] {label} {G_BIG}², {n} shards on {cards} card(s): per-card graphs median "
              f"{med['cards']!r} ms, the mesh's one graph {med['mesh']!r} ms (per card / mesh "
              f"{med['cards'] / med['mesh']:.4f}; medians of {CARD_TIMED} in turns); {k} "
              f"iterations, x bit for bit the mesh's; {reads['host_reads']} reads, "
              f"{reads['replays']} replays in {solves} solves; the run's wall "
              f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
        summary[label] = {"cards_ms": med["cards"], "mesh_ms": med["mesh"], "iterations": k,
                          "reads": reads, "launches": got}
        del op, x_m
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
    sync = compare_sync(torch, smi)
    summary["sync"] = sync
    summary["withheld"] = run_withheld(smi)
    summary["profiled"] = run_profiled(smi)
    summary["card"] = smi
    (OUT / "chip_smoke_cards.json").write_text(json.dumps(summary, indent=1))
    totals = {name: sum(c.get(name, 0) for c in counts.by_path.values())
              for name in (*KERNELS, *SCALAR_BODIES.values(), COND, *SYNC_KERNELS)}
    print(f"[cards] phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals, sync


def _rank_mesh_blocks(shape):
    """(rows, columns) of a rank mesh's shards: N bands or an (R, C) mesh."""
    return (shape, 1) if isinstance(shape, int) else tuple(shape)


def _rank_mesh_rank(device, runs, timed):
    """One rank of phase 16 (spawned by dist.launch_local): each run of ``runs`` on this
    rank's shards of its mesh across the ranks at G_BIG²: its launch counts and the halo
    counts set to 0, a first solve, the sha256 of each of its shards' bytes, then
    ``timed`` solves, each after a barrier, the counts read.  Rank 0 returns {label:
    [each rank's {"digests", "launches", "halo", "local", "transport", "iterations",
    "ms", "buckets"}]}: the halo counts of every solve, the stepped loop's buckets of its
    last solve."""
    import hashlib

    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.kernels import blas1, ell
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg_sharded

    del device
    counters = (st5, blas1, ell)
    out = {}
    for label, (shape, mode, dtype, loop, _needs) in runs.items():
        mesh = dist.make_rank_mesh(shape)
        op = cg_sharded.make_mesh_operator(G_BIG, mesh, mode=mode, dtype=getattr(torch, dtype))
        solve = op.solve_stepped if loop == "stepped" else op.solve
        for c in counters:
            c.reset_launches()
        cg_sharded.reset_halo_calls()
        xs, s = solve()
        digests = [hashlib.sha256(x.cpu().numpy()).hexdigest() for x in xs]
        del xs
        ms = []
        for _ in range(timed):
            dist.barrier()
            t0 = time.perf_counter()
            _, st = solve()  # ends in the loop's read: the card is done
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {n: v for c in counters for n, v in c.LAUNCHES.items() if v}
        buckets = ({k: getattr(st, f"{k}_time_ms") for k in RANK_MESH_BUCKETS}
                   if loop == "stepped" else None)
        out[label] = dist._all_objects({
            "digests": digests, "launches": launches, "halo": dict(cg_sharded.HALO_CALLS),
            "local": list(mesh.local), "transport": op.link.transport,
            "iterations": s.iterations, "ms": ms, "buckets": buckets})
        del op
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
    return out if dist.rank() == 0 else None


def _rank_mesh_halo_missing(shape, rank, solves, iterations):
    """What a rank of a phase-16 run lacks in its halo counts over ``solves`` solves of
    ``iterations`` each: a row exchange an iteration for each of its shards with a N/S
    neighbour, a column exchange for each with a W/E neighbour (local or on the other
    rank), and a side-column correction for each such neighbour."""
    nr, nc = _rank_mesh_blocks(shape)
    ij = [divmod(i, nc) for i in rank["local"]]
    k = solves * iterations
    want = {"exchange": k * sum((i > 0) or (i < nr - 1) for i, _ in ij),
            "column_exchange": k * sum((j > 0) or (j < nc - 1) for _, j in ij),
            "column_correction": k * sum((j > 0) + (j < nc - 1) for _, j in ij)}
    return [f"{n} {rank['halo'][n]} (want {v})" for n, v in want.items()
            if rank["halo"][n] != v]


def phase_rank_mesh(torch, counters, smi, ranks):
    """Phase 16: ranks that each drive a mesh of local shards (``dist.make_rank_mesh``),
    RANK_MESH_RANKS gloo ranks sharing the card, against the one-process mesh of the
    same shape (its one graph, or its stepped loop, beside the path, uncounted) in every
    run of RANK_MESH_RUNS at G_BIG² (``ranks``: what ``_rank_mesh_rank`` returned in phase
    9's group of RANK_MESH_RANKS ranks): the ranks' launches are the path (each rank's set
    to 0 before and read after its solves); every rank's halo counts, each 2-D rank's column
    exchanges and corrections among them; the transport each rank ran (gloo: the ranks
    share the card); x bit for bit by the sha256 of each shard's bytes, 14 iterations
    both; the medians of RANK_MESH_TIMED solves (a solve's time the slowest rank's); the
    stepped run's buckets an iteration beside the one-process mesh's.  Returns {wrapper:
    launches summed over the runs}."""
    import hashlib

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg_sharded

    t_phase = time.perf_counter()
    counts = PathCounts(counters)
    torch.cuda.empty_cache()
    summary = {"card": smi}
    for label, (shape, mode, dtype, loop, needs) in RANK_MESH_RUNS.items():
        every = ranks[label]
        launches = {}
        for r in every:
            for name, v in r["launches"].items():
                launches[name] = launches.get(name, 0) + v
        counts.record(f"rank mesh {label}", needs, launches, {})
        nr, nc = _rank_mesh_blocks(shape)
        mesh = dist.make_band_mesh(nr) if nc == 1 and isinstance(shape, int) \
            else dist.make_mesh((nr, nc))
        op = cg_sharded.make_mesh_operator(G_BIG, mesh, mode=mode, dtype=getattr(torch, dtype))
        solve = op.solve_stepped if loop == "stepped" else op.solve

        def mesh_solves():
            xs, s = solve()
            digests = [hashlib.sha256(x.cpu().numpy()).hexdigest() for x in xs]
            del xs
            ms = []
            for _ in range(RANK_MESH_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, st = solve()
                ms.append((time.perf_counter() - t0) * 1e3)
            return digests, s.iterations, ms, st

        digests, k_mesh, ms_mesh, st_mesh = uncounted(mesh_solves)
        del op
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
        ranks_ms = [max(r["ms"][i] for r in every) for i in range(RANK_MESH_TIMED)]
        med = sorted(ranks_ms)[len(ranks_ms) // 2]
        med_mesh = sorted(ms_mesh)[len(ms_mesh) // 2]
        its = [r["iterations"] for r in every]
        same = [d for r in every for d in r["digests"]] == digests
        transports = [r["transport"] for r in every]
        split = f"{nr}x{nc}" if not isinstance(shape, int) else f"{nr} bands"
        print(f"[ranks] {label} {G_BIG}², {RANK_MESH_RANKS} ranks × "
              f"{nr * nc // RANK_MESH_RANKS} shards of {split} sharing the card over "
              f"{transports}: median {med!r} ms (the slowest rank; each {ranks_ms}), the "
              f"one-process {split} mesh {med_mesh!r} ms (ranks / mesh "
              f"{med / med_mesh:.4f}); iterations {its} (mesh {k_mesh}), x bit for bit by "
              f"each shard's sha256: {same} [{smi}]", flush=True)
        for r, rank in enumerate(every):
            halo = rank["halo"]
            print(f"[ranks] {label} rank {r} (shards {rank['local']}): {halo['exchange']} "
                  f"row exchanges, {halo['column_exchange']} column exchanges, "
                  f"{halo['column_correction']} corrections with exchanged columns over "
                  f"{1 + RANK_MESH_TIMED} solves", flush=True)
            missing = _rank_mesh_halo_missing(shape, rank, 1 + RANK_MESH_TIMED, k_mesh)
            if missing:
                raise AssertionError(f"rank mesh {label} rank {r}: halo counts {missing}")
        if not (same and set(its) == {k_mesh} and k_mesh == 14
                and transports == ["gloo"] * RANK_MESH_RANKS):
            raise AssertionError(f"rank mesh {label}: x bit for bit {same}, iterations {its} "
                                 f"(mesh {k_mesh}), transports {transports}")
        summary[label] = {"ranks_ms": ranks_ms, "median_ms": med, "mesh_ms": ms_mesh,
                          "mesh_median_ms": med_mesh, "iterations": k_mesh,
                          "launches": launches, "halo": [r["halo"] for r in every]}
        if loop == "stepped":
            per_it = {k: [r["buckets"][k] / k_mesh for r in every] for k in RANK_MESH_BUCKETS}
            mesh_it = {k: getattr(st_mesh, f"{k}_time_ms") / k_mesh for k in RANK_MESH_BUCKETS}
            print(f"[ranks] {label}: ms an iteration by bucket, each rank's last solve / the "
                  f"one-process mesh's: " + ", ".join(
                      f"{k} {per_it[k]!r} / {mesh_it[k]!r}" for k in RANK_MESH_BUCKETS)
                  + f" [{smi}]", flush=True)
            if not all(min(v) > 0 for v in per_it.values()):
                raise AssertionError(f"rank mesh {label}: buckets {per_it}")
            summary[label]["buckets_per_iteration"] = per_it
            summary[label]["mesh_buckets_per_iteration"] = mesh_it
    (OUT / "chip_smoke_ranks.json").write_text(json.dumps(summary, indent=1))
    print(f"[ranks] phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts.totals()


def _rank_graph_rank(device, cases, transport=None, spread=False):
    """Phase 17's legs on a rank with cards of its own (spawned by dist.launch_local):
    each case over NCCL eagerly (``graph=False``), then from its graphs (one a rank, or
    one a card), its first solve capturing, then one solve counted (launch counts and
    ``cg.COUNTS`` set to 0 just before it, read just after) and timed.  ``transport`` as
    ``make_mesh_operator``'s ("nccl": a one-rank group).  ``spread``: a rank mesh's shard
    i on card i (a rank's shards on several cards), else a rank's shards on one card.
    Rank 0 returns {label: [each rank's {"eager", "graph": (each shard's sha256,
    iterations), "ms": (eager, graph), "counts", "launches", "replayed", "transport"}]}."""
    import hashlib

    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.kernels import blas1, ell, mesh_sync
    from tpusparse_torch.kernels import graph as graph_kernels
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg, cg_sharded

    counters = (st5, blas1, ell, graph_kernels, mesh_sync)
    w, out = dist.world_size(), {}
    cg_sharded.clear_caches()
    torch.cuda.empty_cache()
    for label, (shape, mode, dtype, _needs) in cases.items():
        dtype = getattr(torch, dtype)
        n = w if shape is None else shape if isinstance(shape, int) else shape[0] * shape[1]
        if shape is None or n == w and transport is None:
            op = cg_sharded.make_sharded_operator(G_BIG, mode=mode, dtype=dtype, device=device,
                                                  mesh_shape=shape)

            def solve(graph):
                x, s = cg_sharded.cg_solve_sharded(G_BIG, operator=op, graph=graph)
                return [x], s
        else:  # a rank's bands or blocks on its own card, or shard i on card i
            per = 1 if spread else n // w
            mesh = dist.make_rank_mesh(shape, devices=[f"cuda:{i // per}" for i in range(n)])
            op = cg_sharded.make_mesh_operator(G_BIG, mesh, mode=mode, dtype=dtype,
                                               transport=transport)

            def solve(graph):
                return op.solve(graph=graph)

        mine, ms = {}, {}
        for leg, graph in (("eager", False), ("graph", None)):
            xs, s = solve(graph)
            mine[leg] = ([hashlib.sha256(x.cpu().numpy()).hexdigest() for x in xs],
                         s.iterations)
            del xs
            for c in (*counters, cg):
                c.reset_launches()
            cg.reset_counts()
            dist.barrier()
            t0 = time.perf_counter()
            solve(graph)
            ms[leg] = (time.perf_counter() - t0) * 1e3
            if leg == "graph":
                mine.update(counts=reads_of(cg.COUNTS), replayed=dict(cg.LAUNCHES),
                            launches=launch_counts((*counters, cg)))
        mine["ms"] = ms
        mine["transport"] = op.link.transport if isinstance(op, cg_sharded.MeshOperator) \
            else op.halo.transport
        out[label] = dist._all_objects(mine)
        del op
        cg_sharded.clear_caches()
        torch.cuda.empty_cache()
    return out if dist.rank() == 0 else None


def _rank_graph_long_rank(device, grid, iters):
    """Phase 17's long one-card solve (in phase 9's one-rank group): a one-rank NCCL rank
    mesh of 2 ``stencil5`` f64 bands on this rank's card, tolerance 0, ``iters``
    iterations from the graph a rank, timed, then again with the loop's wait bound
    (``MeshLoop.bound_s``) a quarter of that time.  Returns {"k", "k_bounded" (None if it
    raised), "error", "s", "bound_s", "same" (x bit for bit), "counts"}."""
    import hashlib

    import torch

    from tpusparse_torch import dist
    from tpusparse_torch.solvers import cg, cg_sharded

    mesh = dist.make_rank_mesh(2, devices=[device, device])
    op = cg_sharded.make_mesh_operator(grid, mesh, mode="stencil5", dtype=torch.float64,
                                       transport="nccl")

    def solve():
        xs, s = op.solve(tolerance=0.0, max_iters=iters)
        return [hashlib.sha256(x.cpu().numpy()).hexdigest() for x in xs], s.iterations

    solve()  # the capture
    (loop,) = op.graphs.values()
    cg.reset_counts()
    t0 = time.perf_counter()
    digests, k = solve()
    took = time.perf_counter() - t0
    out = {"k": k, "s": took, "bound_s": took / 4, "counts": reads_of(cg.COUNTS)}
    loop.bound_s = took / 4
    try:
        again, out["k_bounded"] = solve()
        out.update(error=None, same=again == digests)
    except RuntimeError as e:
        out.update(k_bounded=None, error=str(e), same=False)
    del op, loop
    cg_sharded.clear_caches()
    return out


def _check_rank_graph(cases, out, where, counts, smi, replays=1):
    """``_rank_graph_rank``'s results (``out``) for ``cases``, run ``where``: each rank's
    launches of the path and the condition kernel recorded in ``counts``; x bit for bit the
    eager NCCL loop's (each shard's sha256), the same iterations (14 in f64), one read and
    ``replays`` replays (the rank's cards) a rank a solve, NCCL between the ranks."""
    for label, every in out.items():
        _shape, _mode, dtype, needs = cases[label]
        w = len(every)
        for r, rank in enumerate(every):
            counts.record(f"rank graph {label} rank {r}", (*needs, COND), rank["launches"],
                          rank["replayed"])
        (e_dig, e_k), (g_dig, g_k) = every[0]["eager"], every[0]["graph"]
        same = all(rk["eager"] == rk["graph"] for rk in every)
        ms = {leg: max(rk["ms"][leg] for rk in every) for leg in ("eager", "graph")}
        reads = [rk["counts"] for rk in every]
        print(f"[rank graph] {G_BIG}² {label}, {where} over NCCL "
              f"({sorted({rk['transport'] for rk in every})}): graph {g_k} iterations, "
              f"{ms['graph']!r} ms, eager {e_k} iterations, {ms['eager']!r} ms (one "
              f"solve, the slowest rank); x bit for bit (each shard's sha256): {same}; "
              f"reads and replays a rank a solve {reads} [{smi}]", flush=True)
        if not same or g_k != e_k or (dtype == "float64" and g_k != 14) \
                or reads != [{"host_reads": 1, "replays": replays}] * w \
                or {rk["transport"] for rk in every} != {"nccl"}:
            raise AssertionError(f"rank graph {label}: {every}")


def phase_rank_graph(torch, smi, one_card):
    """Phase 17: a graph a rank over NCCL (``cg_sharded.MeshLoop`` with a rank link), the
    counterpart of the JAX multi-host solve's one compiled ``while_loop`` a process.  On
    one card (a run with no arguments) what phase 9's one-rank NCCL group ran
    (``one_card``): the probe (its WHILE body's all-gather and send/recv pair to itself,
    replayed NCCL_GRAPH_ITERS times on a G_BIG-long row, bit for bit its eager run, the
    condition kernel launched by the replays) and RANK_GRAPH_ONE_CARD, the port's rank
    mesh of 2 bands on the card through ``MeshOperator.solve``, its dots all-gathered by
    NCCL inside the rank's graph, held against its eager loop as below, and that mesh's
    long solve at LONG_GRID² (LONG_ITERS iterations, passing again with its wait bound a
    quarter of its time, x bit for bit).  With two cards or
    more, 4 ranks (2 below four cards) each on a card of its own solve RANK_GRAPH_CASES at
    G_BIG², from the graph a rank against the eager NCCL loop: x bit for bit (each shard's
    sha256), 14 iterations in f64, one replay and one read a rank a solve, each rank's
    launches of the path.  Then a graph a card for ranks that drive several cards
    (``RankCardLoop``), the same bars with one replay a card of the rank: with two or
    three cards one rank over 2 cards in a one-rank NCCL group (RANK_CARDS_ONE_RANK), with
    four 2 ranks over 2 cards each (RANK_CARDS_CASES); on one card a line says that this
    leg needs two.  Returns the path counts' totals, the sync kernels' among them."""
    from tpusparse_torch import dist

    t_phase = time.perf_counter()
    probe, mesh_one_card, long = one_card
    cards = torch.cuda.device_count()
    legs = ["one-rank probe", "one-rank rank mesh", "one-rank long solve"] + (
        [f"{4 if cards >= 4 else 2} ranks on cards of their own",
         "2 ranks x 2 cards, a graph a card" if cards >= 4
         else "1 rank x 2 cards, a graph a card"] if cards >= 2 else [])
    print(f"[rank graph] {cards} card(s) found; legs run: {legs}", flush=True)
    counts = PathCounts(())
    rank0 = probe["every_rank"][0]
    print(f"[rank graph] one-rank NCCL group, a {probe['rows']}-long f64 row sent to itself "
          f"and a partial all-gathered in a captured WHILE body: captured "
          f"{rank0['captured']}, {rank0.get('k')} iterations (eager {probe['k_eager']}), "
          f"bit for bit the eager calls: {rank0.get('same')}; ms an iteration eager "
          f"{probe.get('eager_ms')!r}, graph {probe.get('graph_ms')!r}; "
          f"NCCL_GRAPH_MIXING_SUPPORT={probe['mixing']} [{smi}]", flush=True)
    if not probe["ok"] or rank0.get("k") != NCCL_GRAPH_ITERS:
        raise AssertionError(f"the one-rank NCCL graph probe failed: {rank0}")
    replayed = probe["replayed"]
    counts.record("rank graph one-rank probe", (COND,), {COND: replayed.get(COND, 0)},
                  replayed)
    _check_rank_graph(RANK_GRAPH_ONE_CARD, mesh_one_card, "one rank on one card", counts,
                      smi)
    print(f"[rank graph] {LONG_GRID}² stencil5 f64 2 bands, one rank, tolerance 0: {long['k']} "
          f"iterations from the graph in {long['s']!r} s ({long['counts']}), then with the "
          f"wait bound {long['bound_s']!r} s: {long['k_bounded']} iterations, x bit for bit "
          f"{long['same']}, error {long['error']} [{smi}]", flush=True)
    if long["error"] is not None or not long["same"] or long["k"] != LONG_ITERS \
            or long["k_bounded"] != LONG_ITERS \
            or long["counts"] != {"host_reads": 1, "replays": 1}:
        raise AssertionError(f"rank graph long solve: {long}")
    if cards >= 2:
        w = 4 if cards >= 4 else 2
        out = dist.launch_local(_rank_graph_rank, w, RANK_GRAPH_CASES, device="cuda")
        _check_rank_graph(RANK_GRAPH_CASES, out, f"{w} ranks", counts, smi)
        w, cases = (2, RANK_CARDS_CASES) if cards >= 4 else (1, RANK_CARDS_ONE_RANK)
        out = dist.launch_local(_rank_graph_rank, w, cases, "nccl" if w == 1 else None,
                                True, device="cuda")
        _check_rank_graph(cases, out, f"{w} rank(s) x 2 cards, a graph a card", counts, smi,
                          replays=2)
    else:
        print("[rank graph] a graph a card for ranks that drive several cards "
              "(RankCardLoop) needs two cards; one is visible, so that leg does not run",
              flush=True)
    print(f"[rank graph] phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {name: sum(c.get(name, 0) for c in counts.by_path.values())
            for name in (*KERNELS, *SCALAR_BODIES.values(), COND, *SYNC_KERNELS)}


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
    t_start = last = time.perf_counter()

    def done(phases):
        nonlocal last
        now = time.perf_counter()
        print(f"[phase] {phases} done {now - t_start:.1f} s after the start, {now - last:.1f} "
              f"s for itself", flush=True)
        last = now

    smi = phase_card(torch, sysinfo)
    phase_build(_build)
    print(f"[build] host Matrix Market library (g++): "
          f"{'in use' if native.available() else 'absent, the numpy readers run'}", flush=True)
    cmp = Compare(torch)
    phase_compare(torch, st5, blas1, ell, dia, cmp)
    cond = compare_cond(torch, smi)
    phase_checksum(torch, st5, ell, dia, generate)
    done("1-4")
    results, fused, launches = phase_main_path(torch, (st5, blas1, ell, dia), cg_cli,
                                               spmv_cli)
    done(5)
    times = phase_full_size(torch, st5, blas1, cmp, smi)
    phase_full_size_recompute(torch, st5, cmp, smi, times)
    phase_full_size_bf16(torch, st5, blas1, cmp, smi, times)
    phase_full_size_bands(torch, st5, cmp, smi, times)
    phase_full_size_generic(torch, generate, ell, dia, cmp, smi, times)
    done(6)
    medians = {label: res["timing"]["total_median_ms"] for label, res in results.items()}
    medians.update({label: median_ms for label, (median_ms, _its) in fused.items()})
    splits = phase_profile(torch, smi, medians)
    done(7)
    phase_graph(torch, smi)
    phase_stepped(torch, (st5, blas1, ell, dia, stream_probe), cg_cli, spmv_cli, results,
                  splits, times, smi)
    sharded, later = phase_sharded(torch, results, smi)
    for name, count in sharded.items():
        launches[name] += count
    for name, count in phase_mesh2d(results, smi, later["mesh2d"]).items():
        launches[name] += count
    done("11, 8-10")
    for name, count in phase_scripts(torch, (st5, blas1, ell, dia), smi).items():
        launches[name] += count
    done(12)
    for name, count in phase_entry(torch, (st5, blas1, ell, dia), results, cmp, smi).items():
        launches[name] += count
    done(13)
    for name, count in phase_mesh(torch, (st5, blas1, ell, dia), results, cmp, smi,
                                  splits, later["mesh_x"]).items():
        launches[name] += count
    done(14)
    cards, sync = phase_cards(torch, (st5, blas1, ell, dia), smi)
    for name, count in cards.items():
        launches[name] = launches.get(name, 0) + count
    done(15)
    for name, count in phase_rank_mesh(torch, (st5, blas1, ell, dia), smi,
                                       later["rank_mesh"]).items():
        launches[name] = launches.get(name, 0) + count
    done(16)
    for name, count in phase_rank_graph(torch, smi, later["nccl_graph"]).items():
        launches[name] = launches.get(name, 0) + count
    done(17)
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
        if name in SCALAR_BODIES:
            entry["launches_scalar_body"] = launches[SCALAR_BODIES[name]]
        for key, e in t.items():
            if key != "f32":
                entry.update({f"{k}_{key}": v for k, v in e.items() if k != "bound_by"})
        record["kernels"].append(entry)
    short_name, _fn, source, replaces = COND_ENTRY
    record["kernels"].append({"name": COND, "short": short_name, "route": "cuda",
                              "source": source, "replaces": replaces,
                              "launches": launches[COND], **cond})
    for name, (short_name, _fn, source, replaces) in SYNC_KERNELS.items():
        record["kernels"].append({"name": name, "short": short_name, "route": "cuda",
                                  "source": source, "replaces": replaces,
                                  "launches": launches[name], **sync[name]})
    print(f"nvidia-smi: {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [HEADLINE_CHILD]:
        sys.exit(_headline_child(*sys.argv[2:4]))
    if sys.argv[1:2] == [WITHHELD_CHILD]:
        sys.exit(_withheld_child(sys.argv[2]))
    if sys.argv[1:2] == [PROFILED_CHILD]:
        sys.exit(_profiled_child())
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)

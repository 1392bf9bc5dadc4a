#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpusparse_torch) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, nvcc and PyTorch built
for CUDA; it imports no JAX.  Phases, one line of output or more each:

  1. the card: nvidia-smi's name and power limit, torch's device properties;
  2. build the kernels of tpusparse_torch/csrc/ with nvcc (timed);
  3. each kernel K1-K8 against its plain PyTorch twin on the card, at g = 37, 1000 and
     4096: K1-K3 and K4-K7 in f32 and f64, K8 in its four planes/state pairs (f32/f32,
     f64/f64, bf16/f32, bf16/f64), stencils with and without halo rows (tolerances: f64
     1e-12; f32 1e-5 for fields, 1e-4 for dots, relative to the largest reference
     magnitude);
  4. the SpMVs on ones at 20480² against the analytic checksums: K3 in f32 and f64, K8 in
     f32, bf16c and f64;
  5. the main paths, with every launch count set to 0 before and read after: the CG CLI at
     gen:20480 with mode stencil5-const (f64 recompute, exactly 14 iterations; f32
     recompute; f32 classic, through K3 + K4 + K5 + K6) and mode stencil5 (f64, exactly 14
     iterations; f32) and stencil5-bf16c (f32); the SpMV CLI over stencil5,
     stencil5-bf16c and stencil5-const; the bf16c solution against the f32 stencil5
     solution, bit for bit; one solve from a seeded nonzero x0 (K7), held with the x0 = 0
     solve to the true residual.  Every kernel K1-K8 must have launched;
  6. each kernel against its plain twin at 20480² on seeded random fields at the main
     paths' shapes (same tolerances), then timed against it on those inputs (CUDA events,
     plain/kernel/kernel/plain); the solves' median times, next to the card's name and
     power limit;
  7. one solve of each CG run of phase 5 under torch.profiler, its device time split by
     kernel (PERF.md section 5).

Any failure raises and the exit code is non-zero.  The last lines are the kernels' JSON
record and then {"ok": true, "device": {...}}.  Exports go to chiprun_out/.
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
GRIDS = (37, 1000, 4096)
DIAG, OFFDIAG = 5.0, -1.0
# wrapper name -> (short name, kernel function in the CUDA source, source, the Pallas
# wrapper it replaces), in the order of the kernels line
KERNELS = {
    "spmv_stencil5_const_pupdate_dot": ("K1", "pupdate_dot_kernel",
                                        "tpusparse_torch/csrc/stencil5_const.cu",
                                        "tpusparse/kernels/stencil5.py:861"),
    "cg_const_update_recompute": ("K2", "update_recompute_kernel",
                                  "tpusparse_torch/csrc/stencil5_const.cu",
                                  "tpusparse/kernels/stencil5.py:1014"),
    "spmv_stencil5_const": ("K3", "spmv_kernel", "tpusparse_torch/csrc/stencil5_const.cu",
                            "tpusparse/kernels/stencil5.py:718"),
    "cg_update": ("K4", "cg_update_kernel", "tpusparse_torch/csrc/blas1.cu",
                  "tpusparse/kernels/blas1.py:162"),
    "p_update": ("K5", "p_update_kernel", "tpusparse_torch/csrc/blas1.cu",
                 "tpusparse/kernels/blas1.py:199"),
    "dot": ("K6", "dot_kernel", "tpusparse_torch/csrc/blas1.cu",
            "tpusparse/kernels/blas1.py:80"),
    "axpby_dot": ("K7", "axpby_dot_kernel", "tpusparse_torch/csrc/blas1.cu",
                  "tpusparse/kernels/blas1.py:117"),
    "spmv_stencil5": ("K8", "spmv_planes_kernel", "tpusparse_torch/csrc/stencil5.cu",
                      "tpusparse/kernels/stencil5.py:432"),
}
# the CLI's CG runs of the main path: label -> (mode, arguments, iterations required)
CG_RUNS = {
    "const f64 recompute": ("stencil5-const", ["--dtype=f64"], 14),
    "const f32 recompute": ("stencil5-const", ["--dtype=f32"], None),
    "const f32 classic": ("stencil5-const", ["--dtype=f32", "--loop=classic"], None),
    "stencil5 f64": ("stencil5", ["--dtype=f64"], 14),
    "stencil5 f32": ("stencil5", ["--dtype=f32"], None),
    "bf16c f32": ("stencil5-bf16c", ["--dtype=f32"], None),
}
SPMV_MODES = ("stencil5", "stencil5-bf16c", "stencil5-const")


def rel(a, b) -> float:
    """max |a - b| / max |b|, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class Compare:
    """Kernel-vs-twin comparisons: checks the tolerances (by the state's dtype), keeps
    each kernel's largest absolute and relative errors over all its outputs."""

    def __init__(self, torch):
        self.tol = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4)}
        self.max_abs = {name: 0.0 for name in KERNELS}
        self.max_rel = {name: 0.0 for name in KERNELS}

    def check(self, name, label, dtype, pairs):
        """pairs: [(what, kernel tensor, plain tensor, "field"|"dot"), ...]."""
        field_tol, dot_tol = self.tol[dtype]
        parts = []
        for what, k, p, kind in pairs:
            tol = field_tol if kind == "field" else dot_tol
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
    names = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    return ",".join(names[a] for a in re.findall(r"13__nv_bfloat16|[fd]", mangled))


def phase_build(build):
    """Build the kernels; print each one's registers and spills (ptxas -v), keep the full
    compiler output in chiprun_out/build_log.txt."""
    build.lib()
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(build.build_log)
    kernel = spills = None
    for ln in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)I(.+?)E", ln)
        if m:
            kernel = f"{m.group(1)}<{_template_args(m.group(2))}>"
            spills = "spills not reported"
        elif kernel and "spill" in ln:
            spills = ln.strip()
        elif kernel and "registers" in ln:
            print(f"[build] {kernel}: {ln.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    how = "built" if build.build_log else "loaded an earlier build of the same sources"
    print(f"[build] {how} in {build.build_seconds:.1f} s: {build.BUILD}", flush=True)


def compare_const(torch, st5, cmp, g, dtype, randn):
    """K1-K3 against their twins on a g-wide grid and on a band with halo rows."""
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    dev = torch.device("cuda")
    lab = f"g={g} {dname(dtype)}"
    band = g // 2 + 1  # a ragged band of a larger grid, with true neighbour rows
    x, xb = randn(g, g), randn(band, g)
    hp, hn = randn(1, g), randn(1, g)

    y = st5.spmv_stencil5_const(x, **kw)
    cmp.check("spmv_stencil5_const", lab, dtype,
              [("y", y, st5.spmv_stencil5_const_plain(x, **kw), "field")])
    y, d = st5.spmv_stencil5_const(x, with_dot=True, **kw)
    yp, dp = st5.spmv_stencil5_const_plain(x, with_dot=True, **kw)
    cmp.check("spmv_stencil5_const", lab + " with dot", dtype,
              [("y", y, yp, "field"), ("dot", d, dp, "dot")])
    y, d = st5.spmv_stencil5_const(xb, hp, hn, with_dot=True, **kw)
    yp, dp = st5.spmv_stencil5_const_plain(xb, hp, hn, with_dot=True, **kw)
    cmp.check("spmv_stencil5_const", lab + f" band {band} rows + halos", dtype,
              [("y", y, yp, "field"), ("dot", d, dp, "dot")])

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
                                          "field")])
    del pk
    cmp.check("dot", label, dtype, [("<x,r>", blas1.dot(x, r), blas1.dot_plain(x, r), "dot")])
    zk, dk = blas1.axpby_dot(1.0, x, -1.0, r)
    zp, dp = blas1.axpby_dot_plain(1.0, x, -1.0, r)
    cmp.check("axpby_dot", label, dtype, [("z", zk, zp, "field"), ("<z,z>", dk, dp, "dot")])


def phase_compare(torch, st5, blas1, cmp):
    dev = torch.device("cuda")
    for g in GRIDS:
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device=dev).manual_seed(g)

            def randn(*shape):
                return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

            compare_const(torch, st5, cmp, g, dtype, randn)
            lab = f"g={g} {dname(dtype)}"
            compare_blas1(torch, blas1, cmp, *(randn(g, g) for _ in range(4)), lab)
            band = g // 2 + 1
            for pdt in (dtype, torch.bfloat16):
                pl = f"g={g} planes {dname(pdt)} state {dname(dtype)}"
                compare_k8(torch, st5, cmp, randn(5, g, g).to(pdt), randn(g, g), (), pl)
                compare_k8(torch, st5, cmp, randn(5, band, g).to(pdt), randn(band, g),
                           (randn(1, g), randn(1, g)), pl + f" band {band} rows + halos")
    torch.cuda.synchronize()


def phase_checksum(torch, st5, generate):
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
        check(f"K3 {G_BIG}² {dname(dtype)}",
              st5.spmv_stencil5_const(x, diag=DIAG, offdiag=OFFDIAG))
        for pdt in (dtype, torch.bfloat16) if dtype == torch.float32 else (dtype,):
            planes = generate.make_stencil5_planes_device(G_BIG, DIAG, OFFDIAG, dtype=pdt,
                                                          device="cuda")
            check(f"K8 {G_BIG}² planes {dname(pdt)} state {dname(dtype)}",
                  st5.spmv_stencil5(planes, x))
            del planes
        del x
        torch.cuda.empty_cache()


def phase_main_path(torch, counters, cg_cli, spmv_cli):
    """The main paths through the entry points a user calls.  Returns ({label: CG export},
    {wrapper: launches})."""
    from tpusparse.formats import Stencil5
    from tpusparse_torch import ops
    from tpusparse_torch.kernels import stencil5 as st5
    from tpusparse_torch.solvers import cg

    OUT.mkdir(exist_ok=True)
    results = {}
    for counter in counters:
        counter.reset_launches()
    for label, (mode, extra, iters) in CG_RUNS.items():
        path = OUT / f"chip_smoke_cg_{label.replace(' ', '_')}.json"
        rc = cg_cli.main([f"gen:{G_BIG}", f"--mode={mode}", *extra, f"--json={path}"])
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

    spmv_json = OUT / "chip_smoke_spmv.json"
    rc = spmv_cli.main([f"gen:{G_BIG}", f"--mode={','.join(SPMV_MODES)}", "--runs=3",
                        "--warmup=1", f"--json={spmv_json}"])
    sums = {}
    for mode in SPMV_MODES:
        b = json.loads(spmv_json.with_name(f"{spmv_json.stem}_{mode}.json").read_text())[
            "benchmark"]
        sums[mode] = (b["validation"]["sum_y"], b["validation"]["norm2_y"])
        p = b["performance"]
        print(f"[spmv] {mode} {G_BIG}²: kernel {p['time_kernel_ms']!r} ms, "
              f"{p['bandwidth_gbs']!r} GB/s (roofline share {p['roofline_fraction']!r}), "
              f"run median {p['time_median_ms']!r} ms, sum {sums[mode][0]!r} norm "
              f"{sums[mode][1]!r}", flush=True)
    if rc != 0 or len(set(sums.values())) != 1:
        raise AssertionError(f"spmv_bench at {G_BIG}²: rc {rc}, checksums {sums}")

    # the values-carrying solves' solutions, bit for bit: bf16 planes against f32 planes
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    xs = {}
    for mode in ("stencil5", "stencil5-bf16c"):
        op = ops.get_operator(mode, st, dtype=torch.float32, device="cuda")
        xs[mode], s = cg.cg_solve(op, b_is_ones=True)
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
    x, s = cg.cg_solve(op, op.ones_b(), x0)
    op.free()
    del x0
    res, res_zero = true_residual(x), true_residual(x_zero)
    print(f"[cg] stencil5 f32 from a seeded x0: converged {s.converged}, {s.iterations} "
          f"iterations, true residual {res:.3e} (from x0 = 0: {res_zero:.3e})", flush=True)
    if not (s.converged and res < 1e-5 and res_zero < 1e-5):
        raise AssertionError("CG from a nonzero x0 did not solve the system")
    del x, x_zero
    torch.cuda.empty_cache()

    launches = {name: c.LAUNCHES[name] for c in counters for name in c.LAUNCHES}
    print(f"[launches] main path: {launches}", flush=True)
    missing = [f"{KERNELS[n][0]} {n}" for n in KERNELS if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return results, launches


def _time_ms(torch, fn, n=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _time_pairs(torch, times, key, pairs, label, smi):
    """Time each (kernel, plain) pair in the order plain/kernel/kernel/plain; keep the
    best of each."""
    for name, (kern, plain) in pairs.items():
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(torch, f) for f in (plain, kern, kern, plain))
        times[name][key] = (min(t_k1, t_k2), min(t_p1, t_p2))
        print(f"[time] {KERNELS[name][0]} {name} {label}: kernel {times[name][key][0]!r} ms, "
              f"plain {times[name][key][1]!r} ms [{smi}]", flush=True)


def phase_full_size(torch, st5, blas1, cmp, smi):
    """Each kernel against its twin at G_BIG² on seeded random fields, at the main paths'
    shapes (no halo rows, β ≠ 0), then timed against it on the same inputs.  Returns
    {wrapper: {key: (kernel ms, plain ms)}}, key "f32"/"f64" (K8 also "bf16_f32",
    "bf16_f64": planes_state)."""
    dev = torch.device("cuda")
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
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

        y, d = st5.spmv_stencil5_const(x, with_dot=True, **kw)
        yp, dp = st5.spmv_stencil5_const_plain(x, with_dot=True, **kw)
        cmp.check("spmv_stencil5_const", lab + " with dot", dtype,
                  [("y", y, yp, "field"), ("dot", d, dp, "dot")])
        del yp
        p_before = p.clone()
        pk, dk = st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, **kw)
        if not torch.equal(p, p_before):
            raise AssertionError(f"K1 {lab}: the kernel changed its input p")
        del p_before
        pp, dp = st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, **kw)
        cmp.check("spmv_stencil5_const_pupdate_dot", f"{lab} beta=0.37", dtype,
                  [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])
        del pp
        xk, rk, dk = st5.cg_const_update_recompute(s, x.clone(), r.clone(), p, **kw)
        xp, rp, dp = st5.cg_const_update_recompute_plain(s, x.clone(), r.clone(), p, **kw)
        cmp.check("cg_const_update_recompute", lab, dtype,
                  [("x'", xk, xp, "field"), ("r'", rk, rp, "field"),
                   ("<r',r'>", dk, dp, "dot")])
        del xk, rk, xp, rp
        # y = A·x stands in for Ap in the classic loop's K4
        compare_blas1(torch, blas1, cmp, x, r, p, y, lab)

        _time_pairs(torch, times, key, {
            "spmv_stencil5_const": (
                lambda: st5.spmv_stencil5_const(x, **kw),
                lambda: st5.spmv_stencil5_const_plain(x, **kw)),
            "spmv_stencil5_const_pupdate_dot": (
                lambda: st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, **kw),
                lambda: st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, out=pout, **kw)),
            "cg_const_update_recompute": (
                lambda: st5.cg_const_update_recompute(s, x, r, p, **kw),
                lambda: st5.cg_const_update_recompute_plain(s, x, r, p, **kw)),
            "cg_update": (lambda: blas1.cg_update(s, x, r, p, y),
                          lambda: blas1.cg_update_plain(s, x, r, p, y)),
            "p_update": (lambda: blas1.p_update(s, r, p), lambda: blas1.p_update_plain(s, r, p)),
            "dot": (lambda: blas1.dot(x, r), lambda: blas1.dot_plain(x, r)),
            "axpby_dot": (lambda: blas1.axpby_dot(1.0, x, -1.0, r),
                          lambda: blas1.axpby_dot_plain(1.0, x, -1.0, r)),
        }, lab, smi)
        del pout, y, pk
        for pdt in (dtype, torch.bfloat16):
            torch.cuda.empty_cache()
            planes = torch.rand(5, G_BIG, G_BIG, generator=gen, device=dev, dtype=dtype).to(pdt)
            pl = f"{G_BIG}² planes {dname(pdt)} state {dname(dtype)}"
            compare_k8(torch, st5, cmp, planes, x, (), pl)
            pkey = key if pdt == dtype else f"bf16_{key}"
            _time_pairs(torch, times, pkey, {"spmv_stencil5": (
                lambda: st5.spmv_stencil5(planes, x),
                lambda: st5.spmv_stencil5_plain(planes, x))}, pl, smi)
            del planes
        del x, r, p
    torch.cuda.empty_cache()
    return times


def phase_profile(torch, smi):
    """Where a solve's time goes: one solve of each CG run of phase 5 under torch.profiler
    at G_BIG² (after two unprofiled ones), its device time split by kernel.  "idle" is wall
    time minus the summed device time of the solve's kernels, memsets and copies, not a
    timeline.  The full tables go to chiprun_out/profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpusparse.formats import Stencil5
    from tpusparse_torch import ops
    from tpusparse_torch.solvers import cg

    groups = [(short, re.compile(rf"(?<![a-z_]){fn}")) for short, fn, _s, _r in
              KERNELS.values()]
    groups.append(("final sums", re.compile(r"(?<![a-z_])final_sum_kernel")))
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    tables = []
    for label, (mode, extra, _iters) in CG_RUNS.items():
        dtype = torch.float64 if "--dtype=f64" in extra else torch.float32
        recompute = False if "--loop=classic" in extra else None
        op = ops.get_operator(mode, st, dtype=dtype, device="cuda")
        for _ in range(2):
            cg.cg_solve(op, b_is_ones=True, recompute_ap=recompute)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            x, stats = cg.cg_solve(op, b_is_ones=True, recompute_ap=recompute)
            wall = (time.perf_counter() - t0) * 1e3
        del x
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if not rows:
            raise AssertionError(f"profile {label}: the profiler saw no device time")
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        split = {}
        for e in rows:
            g = next((g for g, pat in groups if pat.search(e.key)), "other device")
            split[g] = split.get(g, 0.0) + e.self_device_time_total / 1e3
        parts = ", ".join(f"{g} {ms!r} ms ({100 * ms / wall:.1f}%)" for g, ms in split.items())
        print(f"[profile] {label} {G_BIG}², {stats.iterations} iterations: wall {wall!r} ms, "
              f"device busy {busy!r} ms; {parts}; idle (wall - busy) {wall - busy!r} ms "
              f"({100 * (wall - busy) / wall:.1f}%) [{smi}]", flush=True)
        tables.append(f"=== {label}: wall {wall!r} ms\n"
                      + prof.key_averages().table(sort_by="self_device_time_total",
                                                  row_limit=16, max_name_column_width=70))
        op.free()
        del op
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "profile.txt").write_text("\n\n".join(tables))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from tpusparse_torch import _build, generate
    from tpusparse_torch.bench import sysinfo
    from tpusparse_torch.cli import cg_solver as cg_cli
    from tpusparse_torch.cli import spmv_bench as spmv_cli
    from tpusparse_torch.kernels import blas1
    from tpusparse_torch.kernels import stencil5 as st5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card(torch, sysinfo)
    phase_build(_build)
    cmp = Compare(torch)
    phase_compare(torch, st5, blas1, cmp)
    phase_checksum(torch, st5, generate)
    results, launches = phase_main_path(torch, (st5, blas1), cg_cli, spmv_cli)
    times = phase_full_size(torch, st5, blas1, cmp, smi)
    phase_profile(torch, smi)
    for label, res in results.items():
        print(f"[solve] {label} {G_BIG}²: median {res['timing']['total_median_ms']!r} ms, "
              f"{res['convergence']['iterations']} iterations, "
              f"{res['statistics']['valid_runs']}/{res['statistics']['total_runs']} valid "
              f"runs [{smi}]")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    record = {"kernels": []}
    for name, (short, _fn, source, replaces) in KERNELS.items():
        t = times[name]
        entry = {"name": name, "short": short, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": cmp.max_abs[name], "max_rel_err": cmp.max_rel[name],
                 "ms": t["f32"][0], "plain_ms": t["f32"][1]}
        for key, (ms, plain_ms) in t.items():
            if key != "f32":
                entry[f"ms_{key}"], entry[f"plain_ms_{key}"] = ms, plain_ms
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpusparse_torch) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, nvcc and PyTorch built
for CUDA; it imports no JAX.  Phases, one line of output or more each:

  1. the card: nvidia-smi's name and power limit, torch's device properties;
  2. build the kernels of tpusparse_torch/csrc/ with nvcc (timed);
  3. each kernel against its plain PyTorch twin on the card, at g = 37, 1000 and 4096, in
     f32 and f64, with and without halo rows (tolerances: f64 1e-12; f32 1e-5 for fields,
     1e-4 for dots, relative to the largest reference magnitude);
  4. the SpMV on ones at 20480² against the analytic checksums;
  5. the main path: the CG CLI at gen:20480 with mode stencil5-const, f64 (must converge in
     exactly 14 iterations), f32, and f32 with --loop=classic; every kernel must have been
     launched by these runs;
  6. each kernel against its plain twin at 20480², f32 and f64, on seeded random fields
     at the main path's shapes (same tolerances), then timed against it on those inputs
     (CUDA events); the solves' median times, next to the card's name and power limit;
  7. one solve of each run of phase 5 under torch.profiler, its device time split by
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
SOURCE = "tpusparse_torch/csrc/stencil5_const.cu"
# wrapper name -> (short name, the Pallas wrapper it replaces)
KERNELS = {
    "spmv_stencil5_const": ("K3", "tpusparse/kernels/stencil5.py:718"),
    "spmv_stencil5_const_pupdate_dot": ("K1", "tpusparse/kernels/stencil5.py:861"),
    "cg_const_update_recompute": ("K2", "tpusparse/kernels/stencil5.py:1014"),
}


def rel(a, b) -> float:
    """max |a - b| / max |b|, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


class Compare:
    """Kernel-vs-twin comparisons: checks the tolerances, keeps each kernel's largest
    absolute and relative errors over all its outputs."""

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
          f"{props.total_memory / 2**30:.1f} GiB", flush=True)
    return smi


def phase_build(build):
    """Build the kernels; print each one's registers and spills (ptxas -v), keep the full
    compiler output in chiprun_out/build_log.txt."""
    build.lib()
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(build.build_log)
    kernel = spills = None
    for ln in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)I([fd])E", ln)
        if m:
            kernel = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
            spills = "spills not reported"
        elif kernel and "spill" in ln:
            spills = ln.strip()
        elif kernel and "registers" in ln:
            print(f"[build] {kernel}: {ln.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    how = "built" if build.build_log else "loaded an earlier build of the same sources"
    print(f"[build] {how} in {build.build_seconds:.1f} s: {build.BUILD}", flush=True)


def phase_compare(torch, st5, cmp):
    dev = torch.device("cuda")
    kw = {"diag": DIAG, "offdiag": OFFDIAG}
    for g in GRIDS:
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device=dev).manual_seed(g)

            def randn(*shape):
                return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

            lab = f"g={g} {str(dtype)[6:]}"
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
                cmp.check("spmv_stencil5_const_pupdate_dot",
                          f"{lab} beta={beta} rows={rows}", dtype,
                          [("p'", pk, pp, "field"), ("<p',Ap'>", dk, dp, "dot")])

            x, r, p = randn(band, g), randn(band, g), randn(band, g)
            a = torch.tensor(0.37, dtype=dtype, device=dev)
            xk, rk, dk = st5.cg_const_update_recompute(a, x.clone(), r.clone(), p, hp, hn, **kw)
            xp, rp, dp = st5.cg_const_update_recompute_plain(a, x.clone(), r.clone(), p, hp,
                                                             hn, **kw)
            cmp.check("cg_const_update_recompute", f"{lab} band {band} rows + halos", dtype,
                      [("x'", xk, xp, "field"), ("r'", rk, rp, "field"),
                       ("<r',r'>", dk, dp, "dot")])
    torch.cuda.synchronize()


def phase_checksum(torch, st5, generate):
    want = generate.stencil5_spmv_checksums(G_BIG, DIAG, OFFDIAG)
    for dtype in (torch.float32, torch.float64):
        y = st5.spmv_stencil5_const(generate.ones_field(G_BIG, dtype, "cuda"), diag=DIAG,
                                    offdiag=OFFDIAG).double()
        got = (float(y.sum()), float(torch.linalg.vector_norm(y)))
        del y
        for what, a, b in (("sum", got[0], want[0]), ("norm", got[1], want[1])):
            if abs(a - b) > 1e-12 * abs(b):
                raise AssertionError(f"checksum {what} at {G_BIG}² {dtype}: {a!r} != {b!r}")
        print(f"[checksum] {G_BIG}² {str(dtype)[6:]}: sum {got[0]!r} norm {got[1]!r} "
              f"(analytic {want[0]!r} {want[1]!r}) ok", flush=True)


def phase_main_path(st5, cg_cli):
    """The CLI runs of the main path; returns {label: export dict}."""
    OUT.mkdir(exist_ok=True)
    runs = {
        "f64 recompute": ["--dtype=f64"],
        "f32 recompute": ["--dtype=f32"],
        "f32 classic": ["--dtype=f32", "--loop=classic"],
    }
    results = {}
    st5.reset_launches()
    for label, extra in runs.items():
        path = OUT / f"chip_smoke_cg_{label.replace(' ', '_')}.json"
        rc = cg_cli.main([f"gen:{G_BIG}", "--mode=stencil5-const", *extra, f"--json={path}"])
        res = json.loads(path.read_text())
        its = res["convergence"]["iterations"]
        print(f"[cg] {label}: rc {rc}, loop {res['loop']}, converged "
              f"{res['convergence']['converged']}, {its} iterations, median "
              f"{res['timing']['total_median_ms']!r} ms", flush=True)
        if rc != 0 or not res["convergence"]["converged"]:
            raise AssertionError(f"CG {label} at {G_BIG}² did not converge (rc {rc})")
        if label.startswith("f64") and its != 14:
            raise AssertionError(f"CG f64 at {G_BIG}² took {its} iterations, not 14")
        results[label] = res
    launches = dict(st5.LAUNCHES)
    print(f"[launches] main path: {launches}", flush=True)
    missing = [n for n, c in launches.items() if c <= 0]
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


def phase_full_size(torch, st5, cmp, smi):
    """Each kernel against its twin at G_BIG² on seeded random fields, at the main path's
    shapes (no halo rows, β ≠ 0), then timed against it on the same inputs (CUDA events,
    order plain/kernel/kernel/plain).  Returns {wrapper: {dtype: (kernel ms, plain ms)}}."""
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
        lab = f"{G_BIG}² {str(dtype)[6:]}"

        y, d = st5.spmv_stencil5_const(x, with_dot=True, **kw)
        yp, dp = st5.spmv_stencil5_const_plain(x, with_dot=True, **kw)
        cmp.check("spmv_stencil5_const", lab + " with dot", dtype,
                  [("y", y, yp, "field"), ("dot", d, dp, "dot")])
        del y, yp
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

        pairs = {
            "spmv_stencil5_const": (
                lambda: st5.spmv_stencil5_const(x, **kw),
                lambda: st5.spmv_stencil5_const_plain(x, **kw)),
            "spmv_stencil5_const_pupdate_dot": (
                lambda: st5.spmv_stencil5_const_pupdate_dot(s, r, p, out=pout, **kw),
                lambda: st5.spmv_stencil5_const_pupdate_dot_plain(s, r, p, out=pout, **kw)),
            "cg_const_update_recompute": (
                lambda: st5.cg_const_update_recompute(s, x, r, p, **kw),
                lambda: st5.cg_const_update_recompute_plain(s, x, r, p, **kw)),
        }
        for name, (kern, plain) in pairs.items():
            t_p1, t_k1, t_k2, t_p2 = (_time_ms(torch, f) for f in (plain, kern, kern, plain))
            times[name][dtype] = (min(t_k1, t_k2), min(t_p1, t_p2))
            print(f"[time] {KERNELS[name][0]} {name} {lab}: kernel "
                  f"{times[name][dtype][0]!r} ms, plain {times[name][dtype][1]!r} ms "
                  f"[{smi}]", flush=True)
        del x, r, p, pout, pairs
    torch.cuda.empty_cache()
    return times


def phase_profile(torch, smi):
    """Where a solve's time goes: one solve of each main-path run under torch.profiler at
    G_BIG² (after two unprofiled ones), its device time split by kernel.  "idle" is wall
    time minus the summed device time of the solve's kernels, memsets and copies, not a
    timeline.  The full tables go to chiprun_out/profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpusparse.formats import Stencil5
    from tpusparse_torch import ops
    from tpusparse_torch.solvers import cg

    groups = (("K1", "pupdate_dot_kernel"), ("K2", "update_recompute_kernel"),
              ("K3", "spmv_kernel"), ("final sums", "final_sum_kernel"))
    st = Stencil5(grid_size=G_BIG, planes=None, constant=(DIAG, OFFDIAG))
    tables = []
    for label, dtype, recompute in (("f64 recompute", torch.float64, True),
                                    ("f32 recompute", torch.float32, True),
                                    ("f32 classic", torch.float32, False)):
        op = ops.get_operator("stencil5-const", st, dtype=dtype, device="cuda")
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
        split = {g: 0.0 for g, _ in groups}
        split["other device"] = 0.0
        for e in rows:
            g = next((g for g, key in groups if key in e.key), "other device")
            split[g] += e.self_device_time_total / 1e3
        parts = ", ".join(f"{g} {ms!r} ms ({100 * ms / wall:.1f}%)" for g, ms in split.items())
        print(f"[profile] {label} {G_BIG}², {stats.iterations} iterations: wall {wall!r} ms, "
              f"device busy {busy!r} ms; {parts}; idle (wall - busy) {wall - busy!r} ms "
              f"({100 * (wall - busy) / wall:.1f}%) [{smi}]", flush=True)
        tables.append(f"=== {label}: wall {wall!r} ms\n"
                      + prof.key_averages().table(sort_by="self_device_time_total",
                                                  row_limit=16, max_name_column_width=70))
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
    from tpusparse_torch.kernels import stencil5 as st5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card(torch, sysinfo)
    phase_build(_build)
    cmp = Compare(torch)
    phase_compare(torch, st5, cmp)
    phase_checksum(torch, st5, generate)
    results, launches = phase_main_path(st5, cg_cli)
    times = phase_full_size(torch, st5, cmp, smi)
    phase_profile(torch, smi)
    for label, res in results.items():
        print(f"[solve] {label} {G_BIG}²: median {res['timing']['total_median_ms']!r} ms, "
              f"{res['convergence']['iterations']} iterations, "
              f"{res['statistics']['valid_runs']}/{res['statistics']['total_runs']} valid "
              f"runs [{smi}]")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    record = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
        "launches": launches[name], "max_abs_err": cmp.max_abs[name],
        "max_rel_err": cmp.max_rel[name],
        "ms": times[name][torch.float32][0], "plain_ms": times[name][torch.float32][1],
        "ms_f64": times[name][torch.float64][0],
        "plain_ms_f64": times[name][torch.float64][1],
    } for name, (_short, replaces) in KERNELS.items()]}
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

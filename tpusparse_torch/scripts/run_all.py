"""One-command reproduce: the port's counterpart of ``scripts/run_all.py`` (the reference's
scripts/run_all.sh, SURVEY.md §2.9).

Detects the device, runs the SpMV benchmark across modes, the single-card CG with its
``bcoo`` (cuSPARSE) and ``csr`` (the ELL kernel) baselines, the sharded CG on 1, 2, 4 and
8 ranks (as many as there are cards; one on the CPU), then prints a speedup and
efficiency summary from the exports.

    python -m tpusparse_torch.scripts.run_all [--quick] [--size=G] [--outdir=results]
        [--modes=...] [--dtype=f32|f64|bf16] [--platform=cuda|cpu]

--quick: g = 256 and 3 runs (the default on the CPU); otherwise g = 4096 and 10 runs.
``--dtype`` is passed to every CLI (their default: f32).  Exports go to ``<outdir>/json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.run_all", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--modes", default="stencil5,stencil5-bf16c,stencil5-const,csr,bcoo")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                    help="the state dtype of every run")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the card's kernels, or their plain twins on the CPU")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..bench import sysinfo
    from ..cli import cg_solver, cg_solver_multichip, spmv_bench

    device = resolve_device(args.platform)
    info = sysinfo.get_system_info(device)
    on_cpu = device.type == "cpu"
    g = args.size or (256 if args.quick or on_cpu else 4096)
    runs = 3 if args.quick or on_cpu else 10
    ndev = 1 if on_cpu else torch.cuda.device_count()
    jdir = os.path.join(args.outdir, "json")
    os.makedirs(jdir, exist_ok=True)
    common = [f"--dtype={args.dtype}", f"--platform={args.platform}"]

    print("=" * 70)
    print(f"tpusparse_torch run_all — {info['device_kind']} x{ndev} "
          f"({info.get('nvidia_smi')}), grid {g}x{g} ({g * g:,} unknowns), {args.dtype}")
    print("=" * 70)

    print("\n--- [1/3] SpMV benchmark ---")
    rc = spmv_bench.main([f"gen:{g}", f"--mode={args.modes}", f"--runs={runs}",
                          "--warmup=2", f"--json={jdir}/spmv.json", *common])
    if rc > 1:  # rc == 1 is a soft per-mode SKIP; don't kill the whole reproduce for it
        return rc

    print("\n--- [2/3] single-card CG ---")
    rc = cg_solver.main([f"gen:{g}", f"--runs={runs}", "--warmup=1", "--verbose=0",
                         f"--json={jdir}/cg_single.json", *common])
    if rc:
        return rc

    print("\n--- [2b] baseline CG (bcoo: cuSPARSE, the independent cross-check, AmgX "
          "role) ---")
    rc = cg_solver.main([f"gen:{g}", "--mode=bcoo", f"--runs={runs}", "--warmup=1",
                         "--verbose=0", f"--json={jdir}/cg_baseline_bcoo.json", *common])
    if rc:
        return rc

    print("\n--- [2c] generic-baseline CG (csr: the hand ELL kernel, cuSPARSE role) ---")
    rc = cg_solver.main([f"gen:{g}", "--mode=csr", f"--runs={runs}", "--warmup=1",
                         "--verbose=0", f"--json={jdir}/cg_baseline_csr.json", *common])
    if rc:
        return rc

    print("\n--- [3/3] sharded CG scaling ---")
    chip_counts = [n for n in (1, 2, 4, 8) if n <= ndev and g % n == 0]
    for n in chip_counts:
        rc = cg_solver_multichip.main(
            [f"gen:{g}", f"--chips={n}", f"--runs={runs}", "--warmup=1",
             f"--json={jdir}/cg_sharded_{n}chip.json", *common])
        if rc:
            return rc

    # summary table (the reference greps its JSONs; we read ours)
    print("\n" + "=" * 70)
    print("SUMMARY")
    print("=" * 70)

    # kernel-only times for the speedup comparison (reference methodology)
    def _kernel_ms(perf):
        t = perf.get("time_kernel_ms")
        return t if t is not None and t > 0 else perf["time_median_ms"]

    def _load(name):
        with open(os.path.join(jdir, name)) as f:
            return json.load(f)

    st = None
    if os.path.exists(os.path.join(jdir, "spmv_stencil5.json")):
        st = _load("spmv_stencil5.json")["benchmark"]["performance"]
        share = (f"{100 * st['roofline_fraction']:.1f}% roofline"
                 if st["roofline_fraction"] is not None else "no data-sheet peak")
        print(f"SpMV stencil5: {_kernel_ms(st):.3f} ms kernel, {st['bandwidth_gbs']:.1f} GB/s "
              f"({share})")
    if st and os.path.exists(os.path.join(jdir, "spmv_csr.json")):
        cs = _load("spmv_csr.json")["benchmark"]["performance"]
        print(f"SpMV csr:      {_kernel_ms(cs):.3f} ms kernel  → stencil5 speedup "
              f"{_kernel_ms(cs) / _kernel_ms(st):.2f}x")
    ours, base_cg = _load("cg_single.json"), _load("cg_baseline_bcoo.json")
    t_ours = ours["timing"]["total_median_ms"]
    t_base = base_cg["timing"]["total_median_ms"]
    same_iters = ours["convergence"]["iterations"] == base_cg["convergence"]["iterations"]
    print(f"CG stencil5 vs bcoo baseline: {t_ours:.2f} vs {t_base:.2f} ms "
          f"({t_base / t_ours:.2f}x, iterations {'match' if same_iters else 'DIFFER'})")
    gen_cg = _load("cg_baseline_csr.json")
    t_gen = gen_cg["timing"]["total_median_ms"]
    gi = gen_cg["convergence"]["iterations"] == ours["convergence"]["iterations"]
    print(f"CG stencil5 vs csr (ELL kernel) baseline: {t_ours:.2f} vs {t_gen:.2f} ms "
          f"({t_gen / t_ours:.2f}x, iterations {'match' if gi else 'DIFFER'})")
    base = None
    print(f"\n{'chips':>5} {'median ms':>10} {'iters':>6} {'speedup':>8} {'efficiency':>10}")
    for n in chip_counts:
        r = _load(f"cg_sharded_{n}chip.json")
        t = r["timing"]["total_median_ms"]
        it = r["convergence"]["iterations"]
        if base is None:
            base = t
        sp = base / t
        print(f"{n:>5} {t:>10.2f} {it:>6} {sp:>7.2f}x {100 * sp / n:>9.1f}%")
    print(f"\n[{info.get('nvidia_smi') or info['device_kind']}] JSONs in", jdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

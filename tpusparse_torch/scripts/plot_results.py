"""Plot benchmark results: the port's counterpart of ``scripts/plot_results.py`` (the
reference's scripts/plotting/plot_results.py role).

Reads the exports that ``run_all`` and ``sweep`` write (``results/json/*.json``) and writes
PNGs:
  - spmv_comparison.png : per-mode SpMV kernel time (log) and bandwidth bars
  - cg_scaling.png      : sharded CG time and efficiency against the rank count
  - cg_problem_size.png : single-rank CG solves against the problem size

Only measured exports of the port are drawn, each figure titled with the device the
exports name (``nvidia_smi``: the card's name and power limit).  Reads exports only, on
any host: matplotlib is needed, the card is not.

    python -m tpusparse_torch.scripts.plot_results [--indir results/json]
        [--outdir results/plots]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# validated categorical palette, fixed slot order
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300", "#4a3aa7",
           "#e34948"]
INK, MUTED = "#333333", "#777777"


def _device(r):
    return r.get("device", {}).get("nvidia_smi") or r.get("device", {}).get("device_kind", "?")


def _exports(pattern):
    out = []
    for p in sorted(glob.glob(pattern)):
        with open(p) as f:
            out.append(json.load(f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.plot_results",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indir", default="results/json")
    ap.add_argument("--outdir", default="results/plots")
    args = ap.parse_args(argv)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[ERROR] matplotlib not available", file=sys.stderr)
        return 1
    os.makedirs(args.outdir, exist_ok=True)
    made = []

    # --- SpMV comparison ---
    spmv, devices = {}, set()
    for r in _exports(f"{args.indir}/*spmv*.json"):
        if r.get("benchmark_type") != "spmv":
            continue
        b = r["benchmark"]
        spmv[(b["matrix"]["rows"], b["mode"])] = b["performance"]
        devices.add(_device(r))
    if spmv:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        modes = sorted({m for _, m in spmv})
        sizes = sorted({n for n, _ in spmv})
        width = 0.8 / max(len(modes), 1)
        for k, mode in enumerate(modes):
            xs, ts, bws = [], [], []
            for i, n in enumerate(sizes):
                if (n, mode) in spmv:
                    perf = spmv[(n, mode)]
                    xs.append(i + k * width)
                    # kernel time (CUDA events), not the transfer-inclusive run median
                    tk = perf.get("time_kernel_ms")
                    ts.append(tk if tk is not None and tk > 0 else perf["time_median_ms"])
                    bws.append(perf["bandwidth_gbs"])
            c = PALETTE[k % len(PALETTE)]
            ax1.bar(xs, ts, width=width, label=mode, color=c)
            ax2.bar(xs, bws, width=width, label=mode, color=c)
        ax1.set_yscale("log")
        for ax, ylabel in ((ax1, "kernel time (ms, log)"), (ax2, "bandwidth (GB/s)")):
            ax.set_xticks(range(len(sizes)))
            ax.set_xticklabels([f"{n:,}" for n in sizes])
            ax.set_xlabel("rows")
            ax.set_ylabel(ylabel)
            ax.legend(fontsize=8)
        fig.suptitle(f"SpMV by mode — {', '.join(sorted(devices))}", fontsize=10)
        fig.tight_layout()
        out = f"{args.outdir}/spmv_comparison.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        made.append(out)

    # --- CG scaling against the rank count ---
    scaling, devices = {}, set()
    for r in _exports(f"{args.indir}/*chip*.json"):
        if r.get("benchmark_type") != "cg":
            continue
        n = int(r["timing"].get("num_chips", 1))
        scaling.setdefault(r["matrix"]["rows"], {})[n] = r["timing"]["total_median_ms"]
        devices.add(_device(r))
    if scaling:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        for rows, by_n in sorted(scaling.items()):
            ns = sorted(by_n)
            ts = [by_n[n] for n in ns]
            base = ts[0] * ns[0]
            ax1.plot(ns, ts, "o-", label=f"{rows:,} unknowns")
            ax2.plot(ns, [100 * base / (t * n) for n, t in zip(ns, ts)], "o-",
                     label=f"{rows:,}")
        ax1.set_xlabel("ranks")
        ax1.set_ylabel("solve time (ms)")
        ax1.set_yscale("log")
        ax2.set_xlabel("ranks")
        ax2.set_ylabel("parallel efficiency (%)")
        ax2.axhline(90, ls="--", c="gray")
        ax2.set_ylim(0, 110)
        for ax in (ax1, ax2):
            ax.set_xscale("log", base=2)
            ax.legend(fontsize=8)
        fig.suptitle(f"CG scaling — {', '.join(sorted(devices))} (ranks on one card take "
                     "turns on it)", fontsize=10)
        fig.tight_layout()
        out = f"{args.outdir}/cg_scaling.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        made.append(out)

    # --- CG against the problem size (single rank, the fastest mode per size) ---
    sizes_cg, devices = {}, set()
    for r in _exports(f"{args.indir}/*.json"):
        if r.get("benchmark_type") != "cg" or "bcoo" in r.get("mode", ""):
            continue
        if int(r["timing"].get("num_chips", 1)) != 1:
            continue
        rows, t = r["matrix"]["rows"], r["timing"]["total_median_ms"]
        devices.add(_device(r))
        if rows not in sizes_cg or t < sizes_cg[rows]:
            sizes_cg[rows] = t
    if len(sizes_cg) >= 2:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        xs = sorted(sizes_cg)
        ax.plot(xs, [sizes_cg[x] for x in xs], "-", lw=2, marker="o", ms=8,
                color=PALETTE[0], label="tpusparse_torch, best mode per size (measured)")
        ax.annotate(f"{sizes_cg[xs[-1]]:.1f} ms", (xs[-1], sizes_cg[xs[-1]]),
                    textcoords="offset points", xytext=(6, -12), color=INK, fontsize=9)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("unknowns (grid points)")
        ax.set_ylabel("CG solve time (ms)")
        ax.grid(True, which="both", color="#e6e6e6", lw=0.5)
        ax.set_axisbelow(True)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        ax.tick_params(colors=MUTED)
        ax.legend(frameon=False, fontsize=9)
        ax.set_title(f"CG time to solution against problem size — "
                     f"{', '.join(sorted(devices))}", color=INK, fontsize=10)
        fig.tight_layout()
        out = f"{args.outdir}/cg_problem_size.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        made.append(out)

    if made:
        print("wrote:", *made, sep="\n  ")
        return 0
    print("[WARN] no plottable JSONs found in", args.indir, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

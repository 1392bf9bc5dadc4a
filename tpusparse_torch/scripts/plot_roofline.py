"""Roofline figure: the port's counterpart of ``scripts/plot_roofline.py`` (the reference's
scripts/plotting/plot_roofline.py role).

Reads the SpMV CLI's exports (``<indir>/spmv_*.json``) and the port's ceiling probe
(``<indir>/probe_ceiling.json``, from ``python -m tpusparse_torch.bench.probes``) and
draws arithmetic intensity (x, log) against achieved GFLOP/s (y, log) under two
ceilings: the data-sheet HBM slope and the measured one.  The card's peaks come from
``bench.sysinfo.GPU_SPECS`` (a device missing from it, the CPU among them, gets no
data-sheet line); only measured exports are drawn, one point a mode at its largest size,
labelled directly.  Reads exports only, on any host: matplotlib is needed, the card is
not.

    python -m tpusparse_torch.scripts.plot_roofline [--indir docs/h100/results]
        [--out results/plots/roofline.png]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.plot_roofline",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indir", default="docs/h100/results")
    ap.add_argument("--out", default="results/plots/roofline.png")
    args = ap.parse_args(argv)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[ERROR] matplotlib not available", file=sys.stderr)
        return 1
    import numpy as np

    from ..bench.sysinfo import gpu_peaks

    points = []  # (mode, rows, ai, gflops)
    device = label = None
    for p in sorted(glob.glob(f"{args.indir}/spmv_*.json")):
        with open(p) as f:
            r = json.load(f)
        if r.get("benchmark_type") != "spmv":
            continue
        b = r["benchmark"]
        points.append((b["mode"], b["matrix"]["rows"], b["analysis"]["arithmetic_intensity"],
                       b["performance"]["gflops"]))
        device = r["device"]["device_kind"]
        label = r["device"].get("nvidia_smi") or device
    if not points:
        print("[WARN] no spmv result JSONs found; nothing to plot", file=sys.stderr)
        return 1
    nominal_bw, peak_gflops = gpu_peaks(device)
    if nominal_bw is None:
        print(f"[WARN] no data-sheet peaks for {device!r} (bench.sysinfo.GPU_SPECS): the "
              "points and the measured ceiling only", file=sys.stderr)
    achievable_bw = None
    probe = os.path.join(args.indir, "probe_ceiling.json")
    if os.path.exists(probe):
        with open(probe) as f:
            achievable_bw = json.load(f)["achievable_gbs"]

    INK, MUTED, C_POINT = "#333333", "#777777", "#2a78d6"
    fig, ax = plt.subplots(figsize=(7.2, 5.0))
    ai_grid = np.logspace(-1.5, 1.5, 64)
    cap = peak_gflops or float("inf")
    if nominal_bw:
        ax.plot(ai_grid, np.minimum(nominal_bw * ai_grid, cap), ls="--", lw=1.4, color=MUTED,
                label=f"data-sheet HBM roofline ({nominal_bw:.0f} GB/s)")
    if achievable_bw:
        ax.plot(ai_grid, np.minimum(achievable_bw * ai_grid, cap), ls="-", lw=1.6,
                color=INK, label=f"measured ceiling ({achievable_bw:.0f} GB/s, probe)")
    best = {}
    for mode, rows, ai, gf in points:
        if mode not in best or rows > best[mode][0]:
            best[mode] = (rows, ai, gf)
    for mode, (rows, ai, gf) in sorted(best.items(), key=lambda kv: kv[1][2]):
        ax.plot([ai], [gf], "o", ms=8, color=C_POINT, mec="white", mew=1.0)
        ax.annotate(f"{mode} ({rows:,} rows)", (ai, gf), textcoords="offset points",
                    xytext=(8, -3), color=INK, fontsize=8)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(ai_grid[0], ai_grid[-1])
    ax.set_xlabel("arithmetic intensity (FLOP / byte)", color=INK)
    ax.set_ylabel("achieved GFLOP/s", color=INK)
    ax.set_title(f"SpMV roofline — {label} (largest measured size a mode)", color=INK,
                 fontsize=10)
    ax.grid(True, which="both", color="#e6e6e6", lw=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.tick_params(colors=MUTED)
    if nominal_bw or achievable_bw:
        ax.legend(frameon=False, fontsize=9, loc="lower right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print(f"[INFO] written: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

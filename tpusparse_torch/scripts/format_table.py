"""Render the format-comparison table from the measured exports: the port's counterpart of
``scripts/format_table.py``.

The reference publishes a per-format, per-size SpMV table (README.md:110-116).  This
renders the port's from the SpMV CLI's exports ``<dir>/spmv_<g>_h100_<mode>.json``
(``python -m tpusparse_torch.cli.spmv_bench gen:<g> --mode=... --json=<dir>/spmv_<g>_h100.json``
on an H100): every mode × every size gets a measured cell, an explained absence
(``ABSENT``), or "not measured".  Output is GitHub markdown.

    python -m tpusparse_torch.scripts.format_table [--dir docs/h100/results]
        [--sizes 1024,2048,4096,10240,20480] [--csv FILE] [--write-doc [FILE]]

``--csv`` regenerates a CSV of the measured cells (and the explained absences) from the
exports; ``--write-doc`` regenerates the comparison document (default
``docs/h100/GENERIC_COMPARISON.md``) from them and the CG exports beside them
(``cg_<g>_h100.json``, ``cg_baseline_bcoo_<g>_h100.json``,
``cg_baseline_csr_<g>_h100.json``).  Neither is edited by hand.  Reads exports only: no
device.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import sys

MODES = ["stencil5", "stencil5-bf16c", "stencil5-const", "stencil5-xla",
         "stencil5-const-xla", "csr", "dia", "dia-xla", "csr-xla", "bcoo"]
TAG = "h100"
# Explained absences on the H100: (mode, size) pairs that cannot or should not run, with
# the reason.  None is known at the table's sizes: every mode ran at 20480² on one H100 80GB
# HBM3 (chip_smoke.py phase 5), and the JAX table's reasons (TPU OOMs at 16 GB, TPU
# compiler failures) do not carry over.  A cell without an export renders as "not
# measured", so gaps stay loud.
ABSENT: dict = {}
# the grid of the CG head-to-head the document reads (run_all --size=4096's exports)
CG_GRID = 4096


def load_rows(results_dir):
    rows = {}
    for path in glob.glob(os.path.join(results_dir, f"spmv_*_{TAG}_*.json")):
        m = re.match(rf"spmv_(\d+)_{TAG}_(.+)\.json$", os.path.basename(path))
        if not m:
            continue
        g, mode = int(m.group(1)), m.group(2)
        with open(path) as f:
            rec = json.load(f)
        p = rec["benchmark"]["performance"]
        rows[(mode, g)] = {
            "ms": p.get("time_kernel_ms") or p["time_median_ms"],
            "gbs": p["bandwidth_gbs"],
            "frac": p.get("roofline_fraction"),
            "flags": p.get("timing_flags") or [],
            "device": rec["device"].get("nvidia_smi") or rec["device"]["device_kind"],
            "raw": rec,
        }
    return rows


def write_csv(rows, absent, sizes, path):
    """Regenerate the format-table CSV from the exports: one row per measured (mode, grid)
    at the table's sizes, plus the explained absences, so that it cannot drift from the
    exports it summarizes."""
    from ..bench.export import _flatten

    flat_rows = []
    for (mode, g) in sorted(rows, key=lambda k: (k[1], k[0])):
        if g not in sizes:
            continue
        flat = _flatten(rows[(mode, g)]["raw"])
        flat["benchmark.performance.timing_flags"] = ";".join(
            f.split(":")[0] for f in rows[(mode, g)]["flags"])
        flat_rows.append(flat)
    for (mode, g), reason in sorted(absent.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        if g not in sizes or (mode, g) in rows:
            continue
        flat_rows.append({"benchmark_type": "spmv", "benchmark.mode": mode,
                          "benchmark.matrix.grid_size": g,
                          "benchmark.absent_reason": reason})
    fieldnames = []
    for r in flat_rows:
        for k in r:
            if k not in fieldnames:
                fieldnames.append(k)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
        w.writeheader()
        for r in flat_rows:
            w.writerow(r)


def _fmt_ms(ms):
    return f"{ms:.3f} ms" if ms >= 0.1 else f"{ms * 1e3:.1f} µs"


def cell(r, mode):
    share = (f", {100 * r['frac']:.0f}% of the sheet" if r.get("frac") is not None
             and mode.startswith("stencil") else "")
    star = "†" if r["flags"] else ""
    return f"{_fmt_ms(r['ms'])}{star} ({r['gbs']:.0f} GB/s{share})"


def render_table(rows, sizes):
    lines = ["| mode \\ grid | " + " | ".join(f"{g}²" for g in sizes) + " |",
             "|---" * (len(sizes) + 1) + "|"]
    for mode in MODES:
        cells = []
        for g in sizes:
            r = rows.get((mode, g))
            if r is not None:
                cells.append(cell(r, mode))
            elif (mode, g) in ABSENT:
                cells.append(f"— {ABSENT[(mode, g)]}")
            else:
                cells.append("not measured")
        lines.append(f"| {mode} | " + " | ".join(cells) + " |")
    if any(rows[k]["flags"] for k in rows if k[1] in sizes and k[0] in MODES):
        lines += ["", "† timing-validity flags set (working set below L2, or a kernel time "
                  "near the launch rate): the bandwidth is not an HBM roofline claim; see the "
                  "export's performance.timing_flags."]
    return lines


def write_generic_comparison(rows, results_dir, sizes, path):
    """Regenerate the comparison document from the exports in ``results_dir``: every
    number below is read from an export at generation time."""
    devices = sorted({r["device"] for r in rows.values()})
    lines = [
        "# STENCIL5 against the generic ELL kernel on the H100",
        "",
        "The reference's central claim is its format comparison (reference README.md:110-116):",
        "STENCIL5 against cuSPARSE CSR at 10k-20k grids, 2.06-2.08x on an A100.  This is the",
        "same experiment for the PyTorch/CUDA port (f32, kernel times from CUDA events around",
        "chained applies, `spmv_bench`'s `time_kernel_ms`), on "
        + (", ".join(f"`{d}`" for d in devices) or "no measured device") + ".",
        "",
        "Regenerated by `python -m tpusparse_torch.scripts.format_table --write-doc` from the",
        f"exports in `{results_dir}`: do not edit the numbers by hand.",
        "",
        "| Matrix size | csr (the port's ELL kernel) | STENCIL5 (K8) | Speedup | "
        "Bandwidth (stencil5) |",
        "|---|---|---|---|---|",
    ]
    for g in sizes:
        c, s = rows.get(("csr", g)), rows.get(("stencil5", g))
        if c is None or s is None:
            continue
        flag = "†" if s["flags"] else ""
        share = f" = {100 * s['frac']:.1f}% of the sheet" if s.get("frac") else ""
        lines.append(f"| **{g}²** ({g * g / 1e6:.1f}M unknowns) | {_fmt_ms(c['ms'])} | "
                     f"{_fmt_ms(s['ms'])}{flag} | **{c['ms'] / s['ms']:.2f}×**{flag} | "
                     f"{s['gbs']:.0f} GB/s{flag}{share} |")
    if any(rows[(m, g)]["flags"] for m in ("csr", "stencil5") for g in sizes
           if (m, g) in rows):
        lines += ["", "† timing-validity flags set (see the export's "
                  "performance.timing_flags): the working set fits L2 or the kernel runs "
                  "near the launch rate."]
    lib = [(g, rows[("bcoo", g)], rows.get(("csr-xla", g)), rows[("csr", g)],
            rows[("stencil5", g)]) for g in sizes
           if all((m, g) in rows for m in ("bcoo", "csr", "stencil5"))]
    if lib:
        lines += ["", "Against the platform's own generic sparse facilities (what a PyTorch "
                  "user gets without a hand kernel):", "",
                  "| size | `bcoo` (cuSPARSE, `torch.sparse_csr_tensor`) | `csr-xla` "
                  "(the plain twin) | csr (ELL kernel) | STENCIL5 |", "|---|---|---|---|---|"]
        for g, bc, cx, ch, st in lib:
            lines.append(f"| {g}² | {_fmt_ms(bc['ms'])} ({bc['ms'] / st['ms']:.1f}× "
                         f"STENCIL5) | {_fmt_ms(cx['ms']) if cx else 'not measured'} | "
                         f"{_fmt_ms(ch['ms'])} | {_fmt_ms(st['ms'])} |")
    cg_rows = []
    for name, label in ((f"cg_{CG_GRID}_{TAG}.json", "stencil5 CG (K8)"),
                        (f"cg_baseline_csr_{CG_GRID}_{TAG}.json", "csr CG (ELL kernel)"),
                        (f"cg_baseline_bcoo_{CG_GRID}_{TAG}.json", "bcoo CG (cuSPARSE)")):
        p = os.path.join(results_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                r = json.load(f)
            cg_rows.append((label, r["timing"]["total_median_ms"],
                            r["convergence"]["iterations"], r.get("dtype", "?"),
                            r["device"].get("nvidia_smi") or r["device"]["device_kind"]))
    if cg_rows:
        lines += ["", f"End-to-end CG head-to-head at {CG_GRID}² (the AmgX-comparison role, "
                  "SURVEY §2.7; `run_all`'s exports):", "",
                  "| solver | median | iterations | dtype | device |", "|---|---|---|---|---|"]
        lines += [f"| {label} | {ms:.2f} ms | {its} | {dt} | {dev} |"
                  for label, ms, its, dt, dev in cg_rows]
    lines += ["", "Reproduce (on the card):", "", "```bash",
              "python -m tpusparse_torch.cli.spmv_bench gen:20480 --mode=stencil5,csr,bcoo "
              "--json=docs/h100/results/spmv_20480_h100.json",
              "python -m tpusparse_torch.scripts.run_all --size=4096   # the CG head-to-heads",
              "python -m tpusparse_torch.scripts.format_table --write-doc "
              "--csv docs/h100/results/spmv_format_table.csv", "```", ""]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusparse_torch.scripts.format_table",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default="docs/h100/results")
    ap.add_argument("--sizes", default="1024,2048,4096,10240,20480")
    ap.add_argument("--csv", default=None,
                    help="also regenerate this CSV from the exports (measured and "
                         "explained-absence rows)")
    ap.add_argument("--write-doc", nargs="?", const="docs/h100/GENERIC_COMPARISON.md",
                    default=None, metavar="FILE",
                    help="regenerate the comparison document from the exports")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = load_rows(args.dir)
    print("\n".join(render_table(rows, sizes)))
    devices = sorted({r["device"] for r in rows.values()})
    print(f"\n[{'; '.join(devices) or 'no export found in ' + args.dir}]")
    if args.csv:
        write_csv(rows, ABSENT, sizes, args.csv)
        print(f"[csv regenerated: {args.csv}]", file=sys.stderr)
    if args.write_doc:
        doc = write_generic_comparison(rows, args.dir, sizes, args.write_doc)
        print(f"[doc regenerated: {doc}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

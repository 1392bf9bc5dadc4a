"""SpMV benchmark CLI of the port.

Counterpart of ``tpusparse/cli/spmv_bench.py`` (reference src/main/main.cu:48-55):

    python -m tpusparse_torch.cli.spmv_bench <matrix.mtx|gen:<g>|gen27:<n>> --mode=<m1[,...]>
        [--json=<file>] [--csv=<file>] [--runs=10] [--warmup=5] [--dtype=f32|f64|bf16]
        [--resident-x] [--ceiling-probe | --ceiling-from=<probe.json>]
        [--platform=cuda|cpu]

All modes are checked before the operand is loaded (main.cu:94-105); a mode whose operator
cannot take the matrix (a stencil mode on a matrix that is no 5-point stencil) is skipped
with ``[SKIP]``, the other modes run, and the exit code is 1; x = ones (:136-137);
5 warm-ups and 10 timed runs with the reference's statistics (``bench.stats``, :158-167);
one export per mode, suffixed ``_<mode>`` (:200-241); Sum(y)/Norm2(y) checksums at 16
decimals (:245-248), summed in f64 at every ``--dtype`` (the JAX CLI sums a bf16 y in bf16,
``tpusparse/cli/spmv_bench.py:172``, and misses the analytic sum).
``gen:<g>`` makes the stencil operand on the device, without a .mtx file, in every mode;
``gen27:<n>`` (or ``gen27:<nx>x<ny>x<nz>``) makes HPCG's 27-point stencil's ELL operand
there, in the ELL modes (the others skip it).

The run times follow ``run_timed`` (upload x, apply, download y) or, with ``--resident-x``,
``run_timed_resident`` (x stays on the card); GFLOPS and GB/s come from the device time of
one apply (``kernel_time_ms``, CUDA events around a chain of applies) and the card's peak
(``tpusparse_torch.bench.metrics``).  ``--ceiling-probe`` measures the achievable
streaming ceiling once, before the modes (``bench.probes.measure_achievable_bw``), and
``--ceiling-from`` reads one from a probe JSON; either way every export then carries
``roofline_fraction_achievable`` beside the data-sheet share, and ``--ceiling-probe`` also
the probe's readings (``ceiling_probe``).  ``--platform=cpu`` runs the plain PyTorch twins
(for tests at small sizes); its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .. import formats, io_mtx, ops
from .._device import host_numpy, resolve_device, resolve_dtype
from ..bench import export, metrics, probes, stats, sysinfo


def load_operand(spec: str):
    """(matrix, display name) of a CLI operand: ``gen:<g>`` is the planes-free constant
    stencil (diag 5, offdiag −1), whose operands the stencil, ELL, DIA and CSR operators
    make on the device; ``gen27:<n>`` or ``gen27:<nx>x<ny>x<nz>`` is HPCG's 27-point
    stencil (diag 26, offdiag −1) on an n³ or nx×ny×nz grid, whose ELL operand the ELL
    modes make on the device (``ops.STENCIL27_MODES``); any other spec is a .mtx file, read
    into sorted CSR."""
    if spec.startswith("gen:"):
        g = int(spec[4:])
        return (formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0)),
                f"stencil5-{g}x{g}")
    if spec.startswith("gen27:"):
        sides = [int(v) for v in spec[6:].split("x")]
        if len(sides) not in (1, 3):
            raise ValueError(f"{spec!r}: give gen27:<n> or gen27:<nx>x<ny>x<nz>")
        nx, ny, nz = sides * 3 if len(sides) == 1 else sides
        return formats.Stencil27(nx, ny, nz, (26.0, -1.0)), f"stencil27-{nx}x{ny}x{nz}"
    coo = io_mtx.load_matrix_market(spec)
    return formats.coo_to_csr(coo), os.path.basename(spec)


def build_parser():
    p = argparse.ArgumentParser(prog="tpusparse_torch.cli.spmv_bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix", help=".mtx path, or gen:<grid_size> or gen27:<n> for synthesis "
                   "on the device")
    p.add_argument("--mode", default="stencil5",
                   help=f"comma-separated SpMV modes ({', '.join(ops.available_modes())})")
    p.add_argument("--json", default=None, help="JSON output base path")
    p.add_argument("--csv", default=None, help="CSV output path (append mode)")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"])
    p.add_argument("--resident-x", action="store_true",
                   help="keep x on the card across timed runs (upload once, read y back "
                        "once): the reference's timed region (spmv_cusparse_csr.cu:234-264). "
                        "By default every run uploads x and downloads y")
    p.add_argument("--ceiling-probe", action="store_true",
                   help="measure the achievable memory ceiling (bench.probes) and report "
                        "roofline_fraction_achievable beside the nominal share")
    p.add_argument("--ceiling-from", default=None, metavar="PROBE_JSON",
                   help="take the achievable ceiling from a probe JSON ('achievable_gbs') "
                        "and report the share of it beside the nominal one")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card's kernels, or their plain twins on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    # check every mode before the (possibly slow) load, reference main.cu:94-105
    for m in modes:
        if m not in ops.available_modes():
            print(f"[ERROR] mode '{m}' is not available. Available: {ops.available_modes()}",
                  file=sys.stderr)
            return 2

    device = resolve_device(args.platform)
    dtype = resolve_dtype(args.dtype)
    mat, name = load_operand(args.matrix)
    info = sysinfo.get_system_info(device)
    print(f"[INFO] device: {info['device_kind']} x{info['num_devices']} "
          f"(backend={info['backend']}, nvidia-smi: {info.get('nvidia_smi')})")
    ceiling = probe = None
    if args.ceiling_from:
        with open(args.ceiling_from) as f:
            ceiling = json.load(f)["achievable_gbs"]
        print(f"[INFO] ceiling from {args.ceiling_from}: achievable {ceiling:.1f} GB/s")
    elif args.ceiling_probe:
        # before any operator is built: the probes hold up to 4.5 GiB of streams
        probe = probes.measure_achievable_bw(device=device)
        ceiling = probe["achievable_gbs"]
        print("[INFO] ceiling probe: " + " / ".join(
            f"{name} {probe[f'{name}_gbs']:.1f}" for name in probe["probes"])
            + f" GB/s -> achievable {ceiling} GB/s (over the data-sheet peak, left out: "
            f"{probe['probes_over_peak'] or 'none'})")

    rc = 0
    for mode in modes:
        try:
            op = ops.get_operator(mode, mat, dtype=dtype, device=device)
        except ValueError as e:
            print(f"[SKIP] mode {mode}: {e}", file=sys.stderr)
            rc = 1
            continue
        x = np.ones(op.num_cols, dtype=op.numpy_dtype)
        if args.resident_x:
            x_dev = op.as_field(x)
            bench = stats.benchmark_with_stats(lambda: op.run_timed_resident(x_dev)[1],
                                               num_runs=args.runs, warmup=args.warmup)
            y_dev, _ = op.run_timed_resident(x_dev)
            y = host_numpy(op.from_field(y_dev))
            del x_dev, y_dev
        else:
            bench = stats.benchmark_with_stats(lambda: op.run_timed(x)[1],
                                               num_runs=args.runs, warmup=args.warmup)
            y, _ = op.run_timed(x)
        y = y.astype(np.float64)  # checksums in f64, a bf16 y widened exactly
        # GFLOPS and GB/s from the device time of one apply (CUDA events); on the CPU the
        # median run stands in
        kernel_ms = op.kernel_time_ms() if device.type == "cuda" else bench.median_ms
        mets = metrics.calculate_spmv_metrics(
            op, kernel_ms, dtype_itemsize=op.dtype.itemsize, device_kind=info["device_kind"],
            l2_bytes=info.get("l2_cache_bytes"), mode=op.name, achievable_gbs=ceiling)
        result = export.spmv_result_dict(
            mode=mode, matrix_name=name, op=op, metrics=mets, stats=bench, sysinfo=info,
            sum_y=float(y.sum()), norm2_y=float(np.linalg.norm(y)), kernel_ms=kernel_ms,
            run_protocol="device-resident" if args.resident_x else "transfer-inclusive")
        result["dtype"] = args.dtype
        if probe is not None:
            result["ceiling_probe"] = probe
        export.print_human_spmv(result)
        print()
        if args.json:
            base, ext = os.path.splitext(args.json)
            path = f"{base}_{mode}{ext or '.json'}"
            export.write_json(path, result)
            print(f"[INFO] JSON written: {path}")
        if args.csv:
            export.append_csv(args.csv, result)
        op.free()
        del op
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""The largest stencil grid one card holds, per mode: the port's counterpart of
``scripts/detect_config.py`` (the reference's scripts/setup/detect_gpu_config.sh: the
largest matrix from the card's memory times a safety factor).

    python -m tpusparse_torch.scripts.detect_config [--platform=cuda|cpu] [--calibrate=G]

Prints the device inventory and, for each mode of ``MODES``, the largest g of a g x g
``gen:<g>`` grid whose CG solve fits: the memory budget (the card's ``hbm_bytes_total``;
on the CPU the host's RAM) times ``SAFETY``, over the words a grid point holds
(``WORDS_PER_POINT``), capped by the kernels' own limits (``cap``) and rounded down to a
multiple of 8, so that K3's vector body (g·itemsize a multiple of 16 bytes) is taken at
f32, f64 and bf16.

``--calibrate=G`` measures the words a point on the card: for each mode, one CG solve
(``cg.cg_solve``'s default, the graph loop; ``bcoo`` runs the eager loop) at G² from a
fresh operator, b = ones, the caller holding x; its peak allocated bytes
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``, the operator's
build included) over G² and the state's item size.  ``WORDS_PER_POINT`` holds what it
printed on one NVIDIA H100 80GB HBM3 at its 700 W limit, at G = 8192.
"""

from __future__ import annotations

import argparse
import math
import sys

# label -> (mode, state dtype, cg_solve's loop arguments)
MODES = {
    "stencil5 f32": ("stencil5", "f32", {}),
    "stencil5 f64": ("stencil5", "f64", {}),
    "stencil5 bf16": ("stencil5", "bf16", {}),
    "stencil5-bf16c f32": ("stencil5-bf16c", "f32", {}),
    "stencil5-const f32 recompute": ("stencil5-const", "f32", {"recompute_ap": True}),
    "stencil5-const f64 recompute": ("stencil5-const", "f64", {"recompute_ap": True}),
    "stencil5-const f32 classic": ("stencil5-const", "f32", {"recompute_ap": False}),
    "stencil5-const bf16 classic": ("stencil5-const", "bf16", {"recompute_ap": False}),
    "csr f32": ("csr", "f32", {}),
    "csr f64": ("csr", "f64", {}),
    "dia f32": ("dia", "f32", {}),
    "bcoo f32": ("bcoo", "f32", {}),
}
ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}
# words of the state's dtype a grid point holds during a CG solve, the caller holding x:
# python -m tpusparse_torch.scripts.detect_config --calibrate=8192 on one NVIDIA H100 80GB
# HBM3, 700.00 W, rounded up to the next 0.01 (the fields: x, r, p and Ap or a second p,
# four in every loop; five coefficient planes in stencil5 and stencil5-bf16c, ten ELL
# words in csr, five DIA diagonals in dia, the CSR's values and columns in bcoo)
WORDS_PER_POINT = {
    "stencil5 f32": 9.01,
    "stencil5 f64": 9.01,
    "stencil5 bf16": 9.01,
    "stencil5-bf16c f32": 6.51,
    "stencil5-const f32 recompute": 4.01,
    "stencil5-const f64 recompute": 4.01,
    "stencil5-const f32 classic": 4.01,
    "stencil5-const bf16 classic": 4.01,
    "csr f32": 14.01,
    "csr f64": 11.51,
    "dia f32": 9.01,
    "bcoo f32": 16.01,
}
SAFETY = 0.85
# the most rows one launch of a stencil kernel covers: gridDim.y <= 65535 blocks of 32
# rows (tps_stencil5_max_rows, csrc/stencil5_const.cu; csrc/stencil5.cu shares the tiling)
STENCIL5_MAX_ROWS = 65535 * 32
INT32_LIMIT = 2 ** 31


def largest(fits, hi: int) -> int:
    """The largest g in [0, hi] with fits(g), for a fits that holds up to some g and never
    after it."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def cap(mode: str) -> int:
    """The largest g the mode's kernels and operands take on ``gen:<g>``, whatever the
    memory:

    - the stencil modes: rows <= STENCIL5_MAX_ROWS a launch;
    - ``csr``: the ELL kernel's int32 columns (``kernels/ell.py``), on the device operand
      g² + g < 2^31 (``generate.make_stencil5_ell_device``);
    - ``bcoo``: int32 row pointers, nnz = 5g² - 4g < 2^31 (``generate.
      make_stencil5_csr_device``), and n = g² < 2^31 (``ops._init_bcoo``);
    - ``dia``: none (64-bit offsets and indices; a block a 256 rows)."""
    if mode == "csr":
        return largest(lambda g: g * g + g < INT32_LIMIT, 2 ** 16)
    if mode == "bcoo":
        return largest(lambda g: 5 * g * g - 4 * g < INT32_LIMIT and g * g < INT32_LIMIT,
                       2 ** 16)
    if mode.startswith("stencil5"):
        return STENCIL5_MAX_ROWS
    return 2 ** 31


def max_grid(mem_bytes: float, itemsize: int, words_per_point: float, limit: int = 2 ** 31,
             safety: float = SAFETY) -> int:
    """The largest multiple of 8 g with g <= ``limit`` whose g² points of
    ``words_per_point`` words of ``itemsize`` bytes fit ``safety`` of ``mem_bytes``."""
    g = min(math.isqrt(int(mem_bytes * safety / (words_per_point * itemsize))), limit)
    return g - g % 8


def grids(mem_bytes: float) -> dict:
    """{label: (largest g, words a point, the mode's cap)} for every mode of MODES."""
    out = {}
    for label, (mode, dtype, _loop) in MODES.items():
        wpp, limit = WORDS_PER_POINT[label], cap(mode)
        out[label] = (max_grid(mem_bytes, ITEMSIZE[dtype], wpp, limit), wpp, limit)
    return out


def calibrate(g: int, device) -> dict:
    """{label: measured words a point} at g² (see the module docstring)."""
    import torch

    from .. import ops
    from ..formats import Stencil5
    from ..solvers import cg

    out = {}
    for label, (mode, dtype, loop) in MODES.items():
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        op = ops.get_operator(mode, Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0)),
                              dtype=dtype, device=device)
        x, stats = cg.cg_solve(op, b_is_ones=True, **loop)
        peak = torch.cuda.max_memory_allocated(device) - base
        out[label] = peak / (g * g * ITEMSIZE[dtype])
        print(f"[calibrate] {label} {g}²: {stats.iterations} iterations, peak "
              f"{peak / 1e9:.3f} GB = {out[label]:.3f} words a point", flush=True)
        del x
        op.free()
        del op
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.scripts.detect_config",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--calibrate", type=int, default=0, metavar="G",
                   help="measure each mode's words a point at G² on the card")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="the card, or the host's RAM as the budget (no solve runs)")
    args = p.parse_args(argv)

    from .. import native
    from .._device import resolve_device
    from ..bench import sysinfo

    device = resolve_device(args.platform)
    info = sysinfo.get_system_info(device)
    print(f"device:      {info['device_kind']} x{info['num_devices']} "
          f"(nvidia-smi: {info.get('nvidia_smi')})")
    print(f"torch:       {info['torch_version']} (backend={info['backend']}, "
          f"cuda={info.get('cuda_version')})")
    print(f"peak HBM:    {info['peak_hbm_gbs']} GB/s per card")
    if device.type == "cuda":
        mem, what = info["hbm_bytes_total"], "card memory"
    else:
        mem, what = info["ram_gb"] * 1e9, "host RAM"
    print(f"budget:      {mem / 1e9:.1f} GB of {what} x {SAFETY} safety")
    if args.calibrate:
        if device.type != "cuda":
            print("[ERROR] --calibrate measures the card's allocator: it needs "
                  "--platform=cuda", file=sys.stderr)
            return 2
        measured = calibrate(args.calibrate, device)
        print("WORDS_PER_POINT = {")
        for label, w in measured.items():
            print(f"    {label!r}: {w:.3f},")
        print("}")
    n = info["num_devices"]
    print("words a point: measured on one NVIDIA H100 80GB HBM3 (700 W) at 8192², the "
          "caller holding x")
    for label, (g, wpp, limit) in grids(mem).items():
        dtype = MODES[label][1]
        capped = " (the kernels' cap)" if g >= limit - limit % 8 else ""
        gn = max_grid(mem * n, ITEMSIZE[dtype], wpp, limit)
        print(f"max grid {label:29s} ({wpp:5.2f} words): {g:>7,}{capped} one card, "
              f"{g * g / 1e9:5.2f}e9 points"
              f"{' > 2^31' if g * g >= INT32_LIMIT else ''} | {gn:>7,} on {n} cards")
    print(f"native io:   {'built' if native.available() else 'numpy fallback'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""SpMV metrics of the port: GFLOPS, bytes, GB/s and the share of the card's peak.

The port's own counterpart of ``tpusparse/bench/metrics.py`` (reference
src/spmv/spmv_metrics.cu): GFLOPS = 2·nnz / t (:63-65), a byte model per mode (:76-95),
arithmetic intensity and the memory/balanced/compute-bound class (:147-167).  What differs
from the JAX module:

  - one byte-model table (``BYTE_MODELS``) of what the port's operands stream: the stencil
    models count coefficient planes, x and y; the ELL, DIA and ``bcoo`` models read the
    operator's ``operand`` (slot-major ELL, DIA data with its stored zeros, a CSR sparse
    tensor), where the JAX models count its TPU packs;
  - the peak is ``sysinfo.gpu_peaks``, this package's table of NVIDIA cards.  A card missing
    from it reports no roofline share (None), no bound class and no above-peak flag;
  - the cache knee is the card's L2 size (``sysinfo``'s ``l2_cache_bytes``).  A working set
    below it can stay in L2 across chained applies, so its GB/s is an L2 figure, not an HBM
    one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .sysinfo import gpu_peaks

# Below this per-apply time a chain of applies between two CUDA events is near the launch
# rate (a few µs a launch), so the window measures launches more than the kernel.
MIN_VALID_KERNEL_MS = 0.05


def spmv_flops(nnz: int) -> int:
    return 2 * nnz  # one multiply + one add per stored nonzero (spmv_metrics.cu:63-65)


def bytes_csr(nnz: int, rows: int, itemsize: int, idxsize: int = 4) -> int:
    """The reference's CSR model (spmv_metrics.cu:76-95): values, column indices, row
    pointers, x read and y written."""
    return nnz * itemsize + nnz * idxsize + (rows + 1) * idxsize + 2 * rows * itemsize


def bytes_ell(rows: int, width: int, itemsize: int, idxsize: int = 4) -> int:
    return rows * width * (itemsize + idxsize) + 2 * rows * itemsize


def bytes_stencil5(rows: int, itemsize: int) -> int:
    """Values-carrying stencil: 5 coefficients, x and y per row, no index traffic (the
    reference's 48 B/row in f64, docs/PROFILING_ANALYSIS.md)."""
    return 7 * rows * itemsize


def bytes_stencil5_const(rows: int, itemsize: int) -> int:
    """Constant-coefficient stencil: x and y only (16 B/row in f64)."""
    return 2 * rows * itemsize


def bytes_dia(rows: int, ndiag: int, itemsize: int) -> int:
    return (ndiag + 2) * rows * itemsize


def _bytes_ell_op(op, itemsize):
    """Slot-major ELL (``kernels.ell``): W values and W int32 columns per row, x read once
    (its other W - 1 reads hit the cache) and y written: W·n·(itemsize + 4) + 2·n·itemsize."""
    return bytes_ell(op.num_rows, op.operand["cols"].shape[0], itemsize)


def _bytes_dia_op(op, itemsize):
    """DIA (``kernels.dia``): ndiag data words per row, stored zeros included, x read once
    and y written: (ndiag + 2)·n·itemsize."""
    return bytes_dia(op.num_rows, op.operand["offsets"].numel(), itemsize)


def _bytes_bcoo_op(op, itemsize):
    """``bcoo`` (a ``torch.sparse_csr_tensor``): the reference's CSR model at the tensor's
    own index width (int32 below 2^31)."""
    return bytes_csr(op.nnz, op.num_rows, itemsize,
                     op.operand["matrix"].col_indices().element_size())


# mode -> bytes of one apply; a plain ``*-xla`` oracle is held to its kernel's model: the
# bytes the operator needs, not the extra passes the plain ops make
BYTE_MODELS = {
    "csr": _bytes_ell_op,
    "ell": _bytes_ell_op,
    "dia": _bytes_dia_op,
    "bcoo": _bytes_bcoo_op,
    "stencil5": lambda op, itemsize: bytes_stencil5(op.num_rows, itemsize),
    # bf16 coefficient planes: 5 planes at 2 B, x and y at the state's itemsize
    "stencil5-bf16c": lambda op, itemsize: op.num_rows * (5 * 2 + 2 * itemsize),
    "stencil5-const": lambda op, itemsize: bytes_stencil5_const(op.num_rows, itemsize),
}


@dataclasses.dataclass
class SpmvMetrics:
    """Parity with the reference's SpmvMetrics (include/spmv.h, spmv_metrics.cu)."""

    time_ms: float
    gflops: float
    bandwidth_gbs: float
    arithmetic_intensity: float
    roofline_fraction: Optional[float]  # achieved GB/s / the card's data-sheet peak
    bound: str  # "memory-bound" | "balanced" | "compute-bound" | "unknown (...)"
    bytes_moved: int
    nnz: int
    rows: int
    dtype: str
    # against a measured streaming ceiling (--ceiling-from), when one was given
    achievable_gbs: Optional[float] = None
    roofline_fraction_achievable: Optional[float] = None
    # non-empty: the GB/s and GFLOPS above are not valid roofline claims
    timing_flags: tuple = ()


def calculate_spmv_metrics(op, time_ms: float, *, dtype_itemsize: int, device_kind: str,
                           l2_bytes: Optional[int] = None, mode: Optional[str] = None,
                           achievable_gbs: Optional[float] = None) -> SpmvMetrics:
    """Metrics of one SpMV apply that took ``time_ms`` on ``device_kind`` (as
    ``sysinfo.get_system_info`` names it), for the state's ``dtype_itemsize``."""
    nbytes = _byte_model(mode or op.name)(op, dtype_itemsize)
    t = time_ms / 1e3
    flops = spmv_flops(op.nnz)
    gflops = flops / t / 1e9 if t > 0 else 0.0
    bw = nbytes / t / 1e9 if t > 0 else 0.0
    ai = flops / nbytes if nbytes else 0.0
    peak_bw, peak_flops = gpu_peaks(device_kind)
    flags = []
    if 0 < time_ms < MIN_VALID_KERNEL_MS:
        flags.append(f"kernel_time<{MIN_VALID_KERNEL_MS}ms: near the launch rate; "
                     "bandwidth/GFLOPS indicative only")
    in_l2 = bool(l2_bytes) and 0 < nbytes < l2_bytes
    if in_l2:
        flags.append(f"working_set_below_l2: {nbytes / 2**20:.1f} MiB < "
                     f"{l2_bytes / 2**20:.0f} MiB of L2 — chained applies can run from L2; "
                     "bandwidth is an L2 figure, not an HBM roofline claim")
    if peak_bw is not None and bw > peak_bw and not in_l2:
        flags.append(f"implied_bw_exceeds_nominal_peak: {bw:.0f} > {peak_bw:.0f} GB/s — "
                     "physically impossible; timing invalid as a roofline claim")
    elif achievable_gbs and bw > achievable_gbs and not in_l2:
        flags.append(f"implied_bw_exceeds_measured_ceiling: {bw:.0f} > {achievable_gbs:.0f} "
                     "GB/s")
    if peak_bw is None:
        bound = "unknown (no peak for this device)"
    else:
        ridge = peak_flops / peak_bw  # FLOPs per byte at the roofline ridge point
        bound = ("memory-bound" if ai < 0.5 * ridge
                 else "compute-bound" if ai > 2.0 * ridge else "balanced")
    return SpmvMetrics(
        time_ms=time_ms,
        gflops=gflops,
        bandwidth_gbs=bw,
        arithmetic_intensity=ai,
        roofline_fraction=bw / peak_bw if peak_bw else None,
        bound=bound,
        bytes_moved=nbytes,
        nnz=op.nnz,
        rows=op.num_rows,
        dtype={4: "float32", 8: "float64"}.get(dtype_itemsize, "?"),
        achievable_gbs=achievable_gbs,
        roofline_fraction_achievable=bw / achievable_gbs if achievable_gbs else None,
        timing_flags=tuple(flags),
    )


def _byte_model(mode):
    for key in (mode, mode.removesuffix("-xla")):
        if key in BYTE_MODELS:
            return BYTE_MODELS[key]
    raise ValueError(f"no byte model for mode '{mode}'")


def cg_gflops(nnz: int, iterations: int, spmv_time_ms: float) -> float:
    """The reference's performance{gflops_spmv} (cg_metrics.cu:~120): 2·nnz·iterations over
    the SpMV time."""
    if spmv_time_ms <= 0:
        return 0.0
    return 2.0 * nnz * iterations / (spmv_time_ms / 1e3) / 1e9

"""SpMV metrics of the port: GFLOPS, bytes, GB/s and the share of the card's peak.

Counterpart of ``calculate_spmv_metrics`` in ``tpusparse/bench/metrics.py``.  The FLOP count
(``spmv_flops``), the byte models (``BYTE_MODELS``) and the result type (``SpmvMetrics``)
are shared with it; what differs is where the card's numbers come from:

  - the peak is ``sysinfo.gpu_peaks``, this package's table of NVIDIA cards.  The shared
    ``chip_peaks`` answers any name it does not know with a TPU v5e's 819 GB/s, which on an
    H100 would report a TPU roofline and flag every run as above peak.  A card missing
    from the table reports no roofline share (None), no bound classification and no
    above-peak flag;
  - the on-chip knee is the card's L2 size (``sysinfo``'s ``l2_cache_bytes``, from
    ``torch.cuda.get_device_properties``), not the shared module's 128 MiB, which was
    measured on a v5e.  A working set below it can stay in L2 across chained applies, so
    its GB/s is an L2 figure, not an HBM one.
"""

from __future__ import annotations

from typing import Optional

from tpusparse.bench.metrics import BYTE_MODELS, SpmvMetrics, spmv_flops

from .sysinfo import gpu_peaks

# Below this per-apply time a chain of applies between two CUDA events is near the launch
# rate (a few µs a launch), so the window measures launches more than the kernel.
MIN_VALID_KERNEL_MS = 0.05


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
    """The shared byte model of a mode.  A plain-PyTorch ``*-xla`` oracle is held to its
    kernel's model: the bytes the operator needs, not the extra passes the plain ops
    make."""
    for key in (mode, mode.removesuffix("-xla")):
        if key in BYTE_MODELS:
            return BYTE_MODELS[key]
    raise ValueError(f"no byte model for mode '{mode}'")

"""The card's achievable memory bandwidth, measured: the port's probes.

Counterpart of ``tpusparse/bench/probes.py``.  The nominal peak (``sysinfo.GPU_SPECS``) is a
data-sheet number; a kernel's share of it under-reports the kernel by whatever the card
cannot reach at all.  These probes measure what the card sustains for plain streaming, and
the SpMV CLI then reports ``roofline_fraction_achievable`` (against the probe) beside
``roofline_fraction`` (against the data sheet).

    python -m tpusparse_torch.bench.probes [--out DIR]

runs on the card and writes ``probe_ceiling.json`` (``measure_achievable_bw``) and
``probe_onchip_knee.json`` (``measure_onchip_knee``) into DIR (default ``chiprun_out/``),
each with the device's provenance (``sysinfo``) and its data-sheet peak.

Protocol: paired-count differencing, as in the JAX package.  A probe is a chain of k
passes over arrays on the device, timed at k_lo and k_hi passes (host clock around the
chain, synchronized, best of ``reps``); the bandwidth comes from the slope
(t_hi - t_lo) / (k_hi - k_lo), which cancels every fixed cost (launch, sync, the host's own
time), with the noise guard of ``slope_seconds``.

A JAX probe is one ``fori_loop`` program, which XLA fuses, so its temporaries never reach
memory.  Eager PyTorch runs every op on its own and writes every temporary, so each pass
here is ONE torch call into buffers made beforehand, and its bytes are what that call
reads and writes (n f32 elements per array, m = n/2 per stream of the mixes):

  read   ``torch.sum(x, 0, out=s)``              n read                     4n B
  copy   ``torch.mul(v, c, out=v)``              n read, n written          8n B
  triad  ``torch.add(b, v, alpha=0.999, out=v)`` 2n read, n written        12n B
  mix7   ``torch.sum(S, 0, out=w)`` over the (6, m) stack S of six streams: six read,
         one written, the values-carrying stencil's 6:1 pattern              28m B
  read6  ``torch.sum(S, 1, out=s6)``: the six streams read at once, six words written
         and no field (JAX's read6 sums six streams into one carried scalar) 24m B
  read_kernel  ``kernels.stream_probe.read``: a kernel written for streaming (16-byte
         loads, eight in flight per thread), n read, one word per block written
                                                                        4n + 4·blocks B
  copy_kernel  ``kernels.stream_probe.copy``: dst = src in 16-byte vectors  8n B

The last two have no JAX counterpart: PyTorch's reduction and elementwise kernels are not
written to stream, and the port's own kernels read above them, so a ceiling taken from
them alone would be a floor.

On a card each chain of k passes is captured once as one ``torch.cuda.CUDAGraph`` (the
counterpart of the JAX probe's single program) and the replay is timed; a capture that
fails raises.  A replay never calls the allocator, so the check is made at capture: a
chain whose passes allocated more than ``ALLOC_SHARE`` of the bytes they move wrote a
temporary the byte count does not hold, and raises.  (A multi-block ``torch.sum``
allocates its partials, a few KB, on every call; a temporary field is at least a seventh
of a pass's bytes.)  On the CPU (tests) the chain is a Python loop over the same calls.

``achievable_gbs`` is the largest reading of the probe set named in ``probes``, leaving out
any probe that reads above the card's data-sheet peak: such a reading is not a ceiling but
a broken probe (a pass that did less work than its byte count), so it stays in the dict
under its own name and is named in ``probes_over_peak``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from .._device import resolve_device
from ..kernels import _launch, stream_probe
from . import sysinfo

PROBES = ("read", "copy", "triad", "mix7", "read6", "read_kernel", "copy_kernel")
# the most a chain's passes may allocate, as a share of the bytes they move
ALLOC_SHARE = 0.01
# the knee's chain length: at least this much device time between k_lo and k_hi at the
# fastest plausible rate, and at most KNEE_MAX_PASSES passes in one graph
KNEE_SECONDS = 0.05
KNEE_RATE_BPS = 4e12
KNEE_MAX_PASSES = 16384


def slope_seconds(t_lo: float, t_hi: float, k_lo: int, k_hi: int) -> float:
    """Seconds per pass from paired-count timings, with the JAX package's noise guard:
    when the fixed-cost jitter exceeds the true slope (t_hi <= t_lo, or a slope under 5%
    of the chain average), the chain average t_hi / k_hi stands in; it is biased high by
    the fixed cost over k_hi, never absurd."""
    slope = (t_hi - t_lo) / (k_hi - k_lo)
    fallback = t_hi / k_hi
    if slope <= 0 or slope < 0.05 * fallback:
        return fallback
    return slope


def _read_probe(x):
    s = torch.empty((), dtype=x.dtype, device=x.device)
    return lambda: torch.sum(x, 0, out=s)


def _copy_probe(x):
    v = x.clone()
    c = torch.tensor(1.0000001, dtype=x.dtype)  # a CPU scalar: no device read, no alloc
    return lambda: torch.mul(v, c, out=v)


def _triad_probe(a, b):
    v = a.clone()
    return lambda: torch.add(b, v, alpha=0.999, out=v)


def _mix7_probe(stack):
    w = torch.empty(stack.shape[1], dtype=stack.dtype, device=stack.device)
    return lambda: torch.sum(stack, 0, out=w)


def _read6_probe(stack):
    s6 = torch.empty(stack.shape[0], dtype=stack.dtype, device=stack.device)
    return lambda: torch.sum(stack, 1, out=s6)


def _read_kernel_probe(x):
    partials = torch.empty(stream_probe.read_partials(x), dtype=x.dtype, device=x.device)
    return lambda: stream_probe.read(x, partials)


def _copy_kernel_probe(x):
    dst = torch.empty_like(x)
    return lambda: stream_probe.copy(x, dst)


def _allocated_bytes(device) -> int:
    return torch.cuda.memory_stats(device).get("allocated_bytes.all.allocated", 0)


def _chain(one_pass, k: int, device, bytes_per_pass: int):
    """k passes as one callable: on a card the replay of a CUDA graph captured over them,
    on the CPU a loop.  Raises when the captured passes allocated more than
    ``ALLOC_SHARE`` of the bytes they move.  A kernel wrapper's count holds the eager
    pass before the capture; the capture launches nothing, and each replay counts its
    launches as replayed (``_launch.count_replay``)."""
    if device.type != "cuda":
        def run():
            for _ in range(k):
                one_pass()
        return run
    one_pass()  # outside the capture: lazy initialisation, the allocator's first blocks
    torch.cuda.synchronize(device)
    before = _allocated_bytes(device)
    graph = torch.cuda.CUDAGraph()
    with _launch.set_apart() as launches, torch.cuda.graph(graph):
        for _ in range(k):
            one_pass()
    grown = _allocated_bytes(device) - before
    if grown > ALLOC_SHARE * k * bytes_per_pass:
        raise RuntimeError(f"a probe chain of {k} passes allocated {grown} bytes: its passes "
                           "write temporaries the byte count does not hold")

    def replay():
        graph.replay()
        _launch.count_replay(launches)

    return replay


def _timed_best(run, reps: int, device) -> float:
    """Best wall seconds of ``run`` over ``reps`` synchronized runs, after one warm-up."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_probe_slope(make_probe, args, bytes_per_pass: int, k_lo: int = 6,
                        k_hi: int = 24, reps: int = 3) -> float:
    """GB/s from the paired-count slope of one probe: ``make_probe(*args)`` returns one
    pass, which moves ``bytes_per_pass`` bytes."""
    device = args[0].device
    one_pass = make_probe(*args)
    t_lo = _timed_best(_chain(one_pass, k_lo, device, bytes_per_pass), reps, device)
    t_hi = _timed_best(_chain(one_pass, k_hi, device, bytes_per_pass), reps, device)
    return bytes_per_pass / slope_seconds(t_lo, t_hi, k_lo, k_hi) / 1e9


def _peak_gbs(device) -> Optional[float]:
    """The card's data-sheet HBM rate, None for the CPU or a card missing from the table."""
    if device.type != "cuda":
        return None
    return sysinfo.gpu_peaks(torch.cuda.get_device_name(device))[0]


def achievable(readings: Dict[str, float], peak_gbs: Optional[float]):
    """(achievable GB/s, [probes over the peak]): the largest reading at or under
    ``peak_gbs`` (every reading when it is None); None when every probe is over it."""
    over = [name for name, gbs in readings.items() if peak_gbs is not None and gbs > peak_gbs]
    kept = [gbs for name, gbs in readings.items() if name not in over]
    return (max(kept) if kept else None), over


def measure_achievable_bw(n_elems: int = 0, k_lo: int = 6, k_hi: int = 24, reps: int = 3,
                          include_mixes: bool = True, device="cuda",
                          peak_gbs: Optional[float] = None) -> Dict:
    """Run the probe set; returns each probe's GB/s under ``<probe>_gbs``, the set run
    (``probes``), those left out for reading above ``peak_gbs`` (``probes_over_peak``;
    default: the card's data-sheet peak, none on the CPU) and ``achievable_gbs``.

    ``n_elems`` defaults to 2^30 f32 (4 GiB) on a card and to 2^20 on the CPU.  The JAX
    package's 2^28 (1 GiB) reads low on the H100: streaming keeps gaining with the
    footprint up to 2-4 GiB, the size of the kernels' own calls at 20480² (the knee's
    points above 512 MiB, ``measure_onchip_knee``).  ``include_mixes`` adds mix7 and read6
    over six streams of n/2 elements (12 GiB on a card)."""
    device = resolve_device(device)
    if n_elems == 0:
        n_elems = 2 ** 30 if device.type == "cuda" else 2 ** 20
    if peak_gbs is None:
        peak_gbs = _peak_gbs(device)
    x = torch.ones(n_elems, dtype=torch.float32, device=device)
    b = torch.full_like(x, 0.5)
    nbytes = x.numel() * x.element_size()
    readings = {
        "read": measure_probe_slope(_read_probe, (x,), nbytes, k_lo, k_hi, reps),
        "copy": measure_probe_slope(_copy_probe, (x,), 2 * nbytes, k_lo, k_hi, reps),
        "triad": measure_probe_slope(_triad_probe, (x, b), 3 * nbytes, k_lo, k_hi, reps),
    }
    del b
    if include_mixes:
        m = max(n_elems // 2, 1)
        stack = torch.stack([torch.full((m,), 1.0 + 1e-7 * i, device=device)
                             for i in range(6)])
        sbytes = m * stack.element_size()
        readings["mix7"] = measure_probe_slope(_mix7_probe, (stack,), 7 * sbytes, k_lo,
                                               k_hi, reps)
        readings["read6"] = measure_probe_slope(_read6_probe, (stack,), 6 * sbytes, k_lo,
                                                k_hi, reps)
        del stack
    readings["read_kernel"] = measure_probe_slope(
        _read_kernel_probe, (x,), nbytes + 4 * stream_probe.read_partials(x), k_lo, k_hi, reps)
    readings["copy_kernel"] = measure_probe_slope(_copy_kernel_probe, (x,), 2 * nbytes, k_lo,
                                                  k_hi, reps)
    del x
    best, over = achievable(readings, peak_gbs)
    return {
        "probe_elems": int(n_elems),
        "probe_protocol": f"paired-count slope (k={k_lo}/{k_hi}, best of {reps}), "
                          + ("one CUDA graph per chain" if device.type == "cuda"
                             else "eager loop"),
        **{f"{name}_gbs": gbs for name, gbs in readings.items()},
        "probes": list(readings),
        "peak_gbs": peak_gbs,
        "probes_over_peak": over,
        "achievable_gbs": best,
    }


def knee_passes(bytes_per_pass: int):
    """(k_lo, k_hi) of a knee point: k_hi gives KNEE_SECONDS of device time between the
    two chains at KNEE_RATE_BPS (k_hi - k_lo is 3/4 of k_hi), within [64,
    KNEE_MAX_PASSES]."""
    k_hi = int(min(max(KNEE_SECONDS / (bytes_per_pass / KNEE_RATE_BPS) / 0.75, 64),
                   KNEE_MAX_PASSES))
    return max(1, k_hi // 4), k_hi


def measure_onchip_knee(sizes_mib=(8, 32, 64, 128, 512, 1024, 2048, 4096), reps: int = 2,
                        device="cuda") -> Dict:
    """Copy-chain bandwidth against the buffer's footprint: where chained timings stop
    being statements about HBM.  A copy chain (``v <- c·v``) over a buffer that fits the
    card's L2 (50 MiB on the H100) runs at the cache's rate after its first pass; the
    default sizes straddle it, and go on to the ceiling probe's 4 GiB, since the HBM rate
    itself still rises with the footprint there.

    Each point keeps its chain lengths and the time of one pass: a pass of a few µs is
    at the launch rate of the graph's kernels, so its GB/s is a floor, not the cache's.
    The JAX package aimed at 0.3 s between its chains against a relay's ms of jitter;
    here a sync jitters by µs, and KNEE_SECONDS keeps a graph to KNEE_MAX_PASSES passes."""
    device = resolve_device(device)
    points = []
    for mib in sizes_mib:
        x = torch.ones(mib * 2 ** 20 // 4, dtype=torch.float32, device=device)
        bytes_per_pass = 2 * x.numel() * x.element_size()
        k_lo, k_hi = knee_passes(bytes_per_pass)
        gbs = measure_probe_slope(_copy_probe, (x,), bytes_per_pass, k_lo, k_hi, reps)
        points.append({"footprint_mib": mib, "copy_chain_gbs": gbs, "k_lo": k_lo,
                       "k_hi": k_hi, "per_pass_us": bytes_per_pass / gbs / 1e3})
        del x
    return {
        "probe_protocol": "copy chain, paired-count slope, footprint-scaled k "
                          f"(best of {reps})",
        "points": points,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpusparse_torch.bench.probes", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="chiprun_out", help="directory of the two JSON files")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    info = sysinfo.get_system_info(device)
    os.makedirs(args.out, exist_ok=True)
    for name, fn in (("probe_ceiling", measure_achievable_bw),
                     ("probe_onchip_knee", measure_onchip_knee)):
        res = {**fn(device=device), "device": info, "nominal_peak_gbs": info["peak_hbm_gbs"]}
        path = os.path.join(args.out, f"{name}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"[probes] {name} -> {path} [{info.get('nvidia_smi')}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

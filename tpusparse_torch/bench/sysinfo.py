"""Device and system provenance for the port's benchmark exports.

Counterpart of ``tpusparse/bench/sysinfo.py``, with the reference's own sources
(gpu_detection.cu): CUDA device properties (:76-108), the ``nvidia-smi`` query (:41-74),
the CPU model (:9-33) and the RAM (:35-39).  The card's power limit is recorded because a
card set below its maximum runs slower under load: every number the port reports carries
it.

Peak figures come from this module's own table of NVIDIA cards (data sheets, dense, no
sparsity).  A card missing from the table reports no peak rather than a guessed one.
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
from typing import Any, Dict, Optional, Tuple

import torch

# The cards the port has run on.  Device name (as torch.cuda.get_device_name reports it)
# -> (HBM GB/s, f32 GFLOP/s without tensor cores).
GPU_SPECS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 67_000.0),  # H100 SXM5
}


def _cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo (reference gpu_detection.cu:9-33)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _ram_gb() -> float:
    """The host's RAM in GB (reference gpu_detection.cu:35-39)."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9
    except (ValueError, OSError):
        return 0.0


def gpu_peaks(device_kind: str) -> Tuple[Optional[float], Optional[float]]:
    return GPU_SPECS.get(device_kind, (None, None))


def nvidia_smi() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for card 0, or
    None where the tool is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def get_system_info(device) -> Dict[str, Any]:
    device = torch.device(device)
    info: Dict[str, Any] = {
        "backend": device.type,
        "torch_version": torch.__version__,
        "cpu_model": _cpu_model(),
        "ram_gb": round(_ram_gb(), 1),
        "hostname": platform.node(),
        "python": platform.python_version(),
    }
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        info.update({
            "device_kind": props.name,
            "platform": "gpu",
            "num_devices": torch.cuda.device_count(),
            "cuda_version": torch.version.cuda,
            "compute_capability": f"{props.major}.{props.minor}",
            "sm_count": props.multi_processor_count,
            "hbm_bytes_total": props.total_memory,
            "l2_cache_bytes": props.L2_cache_size,
            "nvidia_smi": nvidia_smi(),
        })
    else:
        info.update({"device_kind": "cpu", "platform": "cpu", "num_devices": 1})
    peak_bw, peak_flops = gpu_peaks(info["device_kind"])
    info["peak_hbm_gbs"] = peak_bw
    info["peak_f32_gflops"] = peak_flops
    return info

"""Device selection for the port.

The port runs on CUDA.  ``"cpu"`` exists for the tests, which hold the kernels' plain
PyTorch twins against the JAX package at small sizes; it is taken only when asked for by
name.  A CUDA request on a machine without CUDA raises: nothing continues on the CPU
behind the caller's back.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"``, ``"cuda:<i>"``, ``"cpu"`` or a ``torch.device`` -> ``torch.device``."""
    dev = torch.device(name if name is not None else DEFAULT_DEVICE)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available "
                               "(pass device='cpu' explicitly for the plain CPU path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: tpusparse_torch runs on 'cuda' "
                     "(or 'cpu' for the plain twins)")


def resolve_dtype(name) -> torch.dtype:
    """``"f32"``/``"f64"`` or a torch floating dtype -> torch dtype (f32 and f64 only)."""
    if isinstance(name, torch.dtype):
        dtype = name
    else:
        dtype = {"f32": torch.float32, "f64": torch.float64}.get(name)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {name!r}: tpusparse_torch runs f32 and f64")
    return dtype

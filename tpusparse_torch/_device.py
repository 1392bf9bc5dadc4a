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


_DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def resolve_dtype(name) -> torch.dtype:
    """``"f32"``/``"f64"``/``"bf16"`` or a torch dtype of those -> torch dtype.

    A bf16 state is stored in bfloat16 and computed in f32, rounded to bf16 after every
    operation (``kernels/_launch.py`` states the contract); its dots are f32
    (``acc_dtype``)."""
    dtype = name if isinstance(name, torch.dtype) else _DTYPES.get(name)
    if dtype not in _DTYPES.values():
        raise ValueError(f"unsupported dtype {name!r}: tpusparse_torch runs f32, f64 and "
                         "bf16")
    return dtype


def acc_dtype(dtype) -> torch.dtype:
    """The dtype a state's dots accumulate and come back in: f64 for f64, f32 otherwise
    (the counterpart of ``tpusparse/kernels/blas1.py``'s ``_acc_dtype``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def host_numpy(t):
    """A tensor as a numpy array on the host.  numpy has no bfloat16: a bf16 tensor is
    widened to f32 first, which is exact."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

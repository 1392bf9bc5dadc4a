"""Launch plumbing the kernel wrappers share: argument checks, scalars, pointers, streams.

The wrappers call these only on their kernel path, after a CPU tensor has gone to the
plain twin: what reaches them must be a CUDA tensor the kernels can take, or they raise.
"""

from __future__ import annotations

import torch

# state dtypes the kernels take -> the suffix of their C entry points
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check_field(t, like):
    """A contiguous, non-empty CUDA tensor of f32/f64 with ``like``'s device, dtype and
    shape."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor (or CPU for the plain twin), got "
                         f"device {t.device}")
    if t.dtype not in SUFFIX:
        raise ValueError(f"unsupported dtype {t.dtype}: the kernels take float32/float64")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"tensors disagree: {t.device}/{t.dtype} vs "
                         f"{like.device}/{like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"expected a field of shape {tuple(like.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("fields must be contiguous")
    if t.numel() < 1:
        raise ValueError(f"empty field {tuple(t.shape)}")
    return t.numel()


def overlaps(a, b) -> bool:
    """Whether the storage of two contiguous tensors shares any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def check_apart(written, read):
    """Raise unless no tensor of ``written`` (name -> tensor) overlaps another of them or
    one of ``read``: an in-place kernel reads each element it writes in one thread only,
    and neighbouring threads must never see a half-updated field."""
    names = list(written)
    for i, w in enumerate(names):
        for other, t in [*((n, written[n]) for n in names[i + 1:]), *read.items()]:
            if overlaps(written[w], t):
                raise ValueError(f"{w} must not overlap {other}")


def scalar(v, like):
    """α/β as a 0-d tensor on ``like``'s device and dtype (a no-op when it already is)."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(())


def dot_buffers(like, nparts):
    """The 0-d result and the ``nparts`` per-block partials of a kernel's dot."""
    return (torch.empty((), dtype=like.dtype, device=like.device),
            torch.empty(nparts, dtype=like.dtype, device=like.device))


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream

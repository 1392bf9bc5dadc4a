"""Streaming probes: two CUDA kernels that do nothing but move memory, and their twins.

They replace no TPU kernel.  ``bench/probes.py`` times them beside its one-call PyTorch
probes, so that the measured ceiling is set by code written for streaming and not only by
PyTorch's own reduction and elementwise kernels:

  ``read``  partials = per-block sums of an f32 field   (n read; one word per partial written)
  ``copy``  dst = src                                   (n read, n written)

Fields are contiguous f32 tensors whose element count is a multiple of 4 and whose storage
is 16-byte aligned (fresh allocations are): the kernels of ``csrc/stream_probe.cu`` load
and store 16-byte vectors only.  ``read`` writes ``read_partials(x)`` words, whose sum is
the field's; its twin writes the field's sum into the one word the CPU asks for.  A wrapper
given CPU tensors runs the twin; given CUDA tensors it launches the kernel or raises.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (twins do not count).
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import check_field, counter, stream

LAUNCHES = counter(("probe_read", "probe_copy"))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def read_partials(x) -> int:
    """The number of words ``read`` writes for the field x (1 on the CPU)."""
    if x.device.type == "cpu":
        return 1
    return _build.lib().tps_probe_read_partials(x.numel())


def read_plain(x, partials):
    """Plain twin of ``read``: the field's sum into ``partials`` (one word)."""
    return torch.sum(x.reshape(-1), 0, keepdim=True, out=partials)


def copy_plain(src, dst):
    """Plain twin of ``copy``."""
    return dst.copy_(src)


def read(x, partials):
    """Per-block sums of x into ``partials`` (``read_partials(x)`` words); returns them."""
    if x.device.type == "cpu":
        return read_plain(x, partials)
    n = _check_vectors(x, x)
    if partials.dtype != x.dtype or partials.device != x.device or \
            partials.numel() != read_partials(x) or not partials.is_contiguous():
        raise ValueError(f"partials must be {read_partials(x)} contiguous f32 words on "
                         f"{x.device}")
    _build.check(_build.lib().tps_probe_read_f32(x.data_ptr(), n, partials.data_ptr(),
                                                 stream(x)), "probe_read")
    LAUNCHES["probe_read"] += 1
    return partials


def copy(src, dst):
    """dst = src; returns dst."""
    if src.device.type == "cpu":
        return copy_plain(src, dst)
    n = _check_vectors(src, src)
    _check_vectors(dst, src)
    _build.check(_build.lib().tps_probe_copy_f32(src.data_ptr(), dst.data_ptr(), n,
                                                 stream(src)), "probe_copy")
    LAUNCHES["probe_copy"] += 1
    return dst


def _check_vectors(t, like):
    n = check_field(t, like)
    if t.dtype != torch.float32 or n % 4 or t.data_ptr() % 16:
        raise ValueError(f"the streaming probes take f32 fields of a multiple of 4 elements "
                         f"on a 16-byte boundary, got {t.dtype}, {n} elements at "
                         f"{t.data_ptr() % 16} bytes past one")
    return n

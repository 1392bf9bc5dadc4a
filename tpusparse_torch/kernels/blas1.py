"""The classic CG loop's BLAS1 passes: CUDA kernels and their plain PyTorch twins.

Counterpart of ``tpusparse/kernels/blas1.py``.  Four wrappers, one per Pallas kernel:

  ``cg_update``  K4, x += α·p and r -= α·Ap in place, and <r, r>   (``cg_update_pallas``)
  ``p_update``   K5, p = r + β·p in place                          (``p_update_pallas``)
  ``dot``        K6, <a, b>                                        (``dot_pallas``)
  ``axpby_dot``  K7, z = α·x + β·y and <z, z>                      (``axpby_dot_pallas``)

Fields are f32, f64 or bf16 tensors of any shape (the CG state is a (g, g) field),
contiguous, all of one dtype; dots come back as 0-d tensors in the dtype they accumulate
in, as the Pallas kernels accumulate (``blas1._acc_dtype``: f32 for f32 and bf16, f64 for
f64).  α and β are 0-d tensors or Python floats, cast to the state's dtype (bf16 for a
bf16 state, as in JAX); the kernels read them through a device pointer.  A bf16 state
rounds every field operation to bf16 in the Pallas kernels' order (``_launch``'s
contract): the twins are the same bf16 torch expressions.

Each wrapper has a ``*_plain`` twin of the same signature in plain PyTorch.  A wrapper
given CPU tensors runs the twin; given CUDA tensors it launches the kernel from
``tpusparse_torch/csrc/blas1.cu`` or raises; there is no fallback between the two.  Kernel
and twin round every field operation alike, so their fields agree bit for bit; the dots
differ only in summation order.

K5 and K6 load 16 bytes a thread when their two operands lie at the same offset mod 16
bytes (fresh allocations do), and one element at a time otherwise (a view one element into
its storage, say); the C launcher picks the body from the pointers, and both give the same
p bit for bit.  K6 adds its per-block partials inside its one launch: the last block to
finish sums them in index order, so a dot is bitwise repeatable; it counts blocks on a
ticket counter per device and stream (``_launch.dot_tickets``) that it leaves at 0.

The Pallas ``cg_update_pallas`` aliased x and r onto its outputs; here x, r (K4) and p
(K5) are updated in place too, which is safe on a GPU because every element is read and
written by one thread.  The one hazard is aliasing between inputs: in the JAX loop p *is*
r on the first iteration, so K4 (kernel and twin alike) raises when p or Ap overlaps x or
r, and K5 when r overlaps p.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (twins do not count).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .._device import acc_dtype
from ._launch import (SUFFIX, check_apart, check_field, counter, dot_buffers, dot_tickets,
                      scalar, stream)

LAUNCHES = counter(("cg_update", "p_update", "dot", "axpby_dot"))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def dot_plain(a, b):
    """Plain twin of ``dot``, accumulated in ``acc_dtype`` (a bf16 state's dot in f32)."""
    acc = acc_dtype(a.dtype)
    return torch.dot(a.reshape(-1).to(acc), b.reshape(-1).to(acc))


def cg_update_plain(alpha, x, r, p, ap):
    """Plain twin of ``cg_update``: updates x and r in place, as the kernel does."""
    check_apart({"x": x, "r": r}, {"p": p, "ap": ap})
    alpha = scalar(alpha, r)
    x.add_(alpha * p)
    r.sub_(alpha * ap)
    return x, r, dot_plain(r, r)


def p_update_plain(beta, r, p):
    """Plain twin of ``p_update``: updates p in place."""
    check_apart({"p": p}, {"r": r})
    beta = scalar(beta, r)
    return p.mul_(beta).add_(r)  # (β·p) + r rounds as r + β·p


def axpby_dot_plain(alpha, x, beta, y):
    """Plain twin of ``axpby_dot``."""
    z = scalar(alpha, x) * x + scalar(beta, x) * y
    return z, dot_plain(z, z)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cg_update(alpha, x, r, p, ap):
    """(x, r, <r, r>) after x += α·p and r -= α·Ap, in place, in one pass.

    Replaces the Pallas kernel ``cg_update_pallas``.  p and Ap must overlap neither x nor
    r."""
    if r.device.type == "cpu":
        return cg_update_plain(alpha, x, r, p, ap)
    n = check_field(r, r)
    for t in (x, p, ap):
        check_field(t, r)
    check_apart({"x": x, "r": r}, {"p": p, "ap": ap})
    alpha = scalar(alpha, r)
    dot, part = dot_buffers(r, _partials(n))
    fn = getattr(_build.lib(), f"tps_cg_update_{SUFFIX[r.dtype]}")
    _build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
                    n, part.data_ptr(), dot.data_ptr(), stream(r)), "cg_update")
    LAUNCHES["cg_update"] += 1
    return x, r, dot


def p_update(beta, r, p):
    """p = r + β·p, in place; returns p.

    Replaces the Pallas kernel ``p_update_pallas``.  r must not overlap p."""
    if r.device.type == "cpu":
        return p_update_plain(beta, r, p)
    n = check_field(r, r)
    check_field(p, r)
    check_apart({"p": p}, {"r": r})
    beta = scalar(beta, r)
    fn = getattr(_build.lib(), f"tps_p_update_{SUFFIX[r.dtype]}")
    _build.check(fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), n, stream(r)), "p_update")
    LAUNCHES["p_update"] += 1
    return p


def dot(a, b):
    """<a, b> as a 0-d tensor, in one launch.

    Replaces the Pallas kernel ``dot_pallas``."""
    if a.device.type == "cpu":
        return dot_plain(a, b)
    n = check_field(a, a)
    check_field(b, a)
    out, part = dot_buffers(a, _partials(n))
    s = stream(a)
    fn = getattr(_build.lib(), f"tps_dot_{SUFFIX[a.dtype]}")
    _build.check(fn(a.data_ptr(), b.data_ptr(), n, part.data_ptr(), out.data_ptr(),
                    dot_tickets(a, s).data_ptr(), s), "dot")
    LAUNCHES["dot"] += 1
    return out


def axpby_dot(alpha, x, beta, y):
    """(z, <z, z>) with z = α·x + β·y in a new field, in one pass (r0 = b - A·x0 and its
    norm).

    Replaces the Pallas kernel ``axpby_dot_pallas``."""
    if x.device.type == "cpu":
        return axpby_dot_plain(alpha, x, beta, y)
    n = check_field(x, x)
    check_field(y, x)
    alpha, beta = scalar(alpha, x), scalar(beta, x)
    z = torch.empty_like(x)
    dot, part = dot_buffers(x, _partials(n))
    fn = getattr(_build.lib(), f"tps_axpby_dot_{SUFFIX[x.dtype]}")
    _build.check(fn(alpha.data_ptr(), x.data_ptr(), beta.data_ptr(), y.data_ptr(),
                    z.data_ptr(), n, part.data_ptr(), dot.data_ptr(), stream(x)),
                 "axpby_dot")
    LAUNCHES["axpby_dot"] += 1
    return z, dot


# the library's size query, asked once per size so that a launch makes one foreign call,
# the kernel's own
@functools.lru_cache(maxsize=64)
def _partials(n):
    return _build.lib().tps_blas1_partials(n)

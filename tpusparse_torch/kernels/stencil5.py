"""5-point stencil passes: CUDA kernels and their plain PyTorch twins.

Counterpart of ``tpusparse/kernels/stencil5.py``.  The operators act on a (rows, g) row
band of a g-wide grid; N/S of the band's first and last rows come from the optional
(1, g) halo rows (``None`` = zero, the grid edge); W/E at the side columns are zero.  Six
wrappers, one per Pallas kernel:

  ``spmv_stencil5``                    K8, y = A·x with coefficient planes, optionally <x, A·x>
  ``spmv_stencil5_pupdate``            K9, fused CG pass: p' = r + β·p, y = A·p' (planes),
                                       <p', y>
  ``spmv_stencil5_const``              K3, y = A·x for diag·x + offdiag·(N + S + W + E)
  ``spmv_stencil5_const_pupdate_dot``  K1, recompute-CG pass A: p' = r + β·p, <p', A·p'>
  ``cg_const_update_recompute``        K2, recompute-CG pass B: x += α·p, r -= α·A·p, <r, r>
  ``spmv_stencil5_const_pupdate``      K10, K9 for the constant stencil

Each has a ``*_plain`` twin of the same signature in plain PyTorch.  A wrapper given CPU
tensors runs the twin; given CUDA tensors it launches the kernel from
``tpusparse_torch/csrc/stencil5.cu`` (K8, K9) or ``stencil5_const.cu`` (K1-K3, K10) or
raises; there is no fallback between the two.  Kernel and twin round every field operation
alike, so their fields agree bit for bit; the dots differ only in summation order.  Dots
come back as 0-d tensors in the dtype they accumulate in (f32 for a bf16 state); α and β
are 0-d tensors (or Python floats) that the kernels read through a device pointer.

A bf16 state (``_launch``'s rounding contract) has kernels for K8 (bf16 planes) and K3
only: the JAX package's recompute and fused loops, which K1, K2, K9 and K10 serve, reject
a bf16 state, so their wrappers raise ``ValueError`` for one on a card.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (twins do not count).
K3 and K8 take ``out=``, a field to write y into: the sharded solver writes a
band's rows piece by piece into one y.  K9 and K10 take ``y_out=`` for their y: the
device-resident CG loop hands every wrapper its fields, so that its captured body
allocates nothing.

K3, K1 and K2 have two CUDA bodies each (``csrc/stencil5_const.cu``): the vector body, a
16-byte vector of columns a thread, which finishes its dot in the same launch, and the
scalar body, one element a thread.  Their wrappers launch the vector body whenever
``const_vector_fits`` holds for every operand of the launch and the scalar body otherwise;
a wrapper's ``LAUNCHES`` entry counts both bodies, the entry ``<wrapper>_scalar`` the
scalar body's launches alone.  The vector bodies' one-launch dots take
the ticket counter of ``_launch.dot_tickets``: one a stream eagerly, the workspace's in a
captured loop, whose launches run one after another on one stream.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..formats import C, E, N, S, W
from ._launch import (SUFFIX, check_apart, check_field, check_state, counter, dot_buffers,
                      dot_tickets, overlaps, ptr, scalar, stream)
from .blas1 import dot_plain as _dot

LAUNCHES = counter((
    "spmv_stencil5",
    "spmv_stencil5_pupdate",
    "spmv_stencil5_const",
    "spmv_stencil5_const_scalar",
    "spmv_stencil5_const_pupdate_dot",
    "spmv_stencil5_const_pupdate_dot_scalar",
    "cg_const_update_recompute",
    "cg_const_update_recompute_scalar",
    "spmv_stencil5_const_pupdate",
))

# planes dtype -> the part of the K8/K9 entry points' suffix before the state's
_PLANES_SUFFIX = {torch.float32: "", torch.float64: "", torch.bfloat16: "bf16_"}
# tiles of 32 rows one block of a vector body takes, one under the other
# (csrc/stencil5_const.cu), K3's without and with its dot: a block's share of the dot (its
# reduction, fence and ticket) costs about what streaming a tile does, so a block of a
# dot's launch takes four (K3, K1); K2's blocks, which hold x and r besides p (two blocks
# an SM), stream best taking two.  bench/k3_layouts.py times 1 to 8 for K3; PERF.md
# section 6 keeps the timings of 1 to 8 for K1 and K2
VEC_STACK = {False: 1, True: 4}
UPDATE_VEC_STACK = 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _neighbours(x, halo_prev, halo_next):
    """x's N, S, W and E neighbour fields: the halo rows (or zero) beyond the band's first
    and last rows, zero beyond the side columns."""
    rows, g = x.shape
    zrow = x.new_zeros((1, g))
    top = zrow if halo_prev is None else halo_prev.reshape(1, g)
    bot = zrow if halo_next is None else halo_next.reshape(1, g)
    zcol = x.new_zeros((rows, 1))
    return (torch.cat([top, x[:-1]], 0), torch.cat([x[1:], bot], 0),
            torch.cat([zcol, x[:, :-1]], 1), torch.cat([x[:, 1:], zcol], 1))


def spmv_stencil5_plain(planes, x, halo_prev=None, halo_next=None, *, with_dot=False,
                        out=None):
    """Plain twin of ``spmv_stencil5``; the port of ``spmv_stencil5_xla`` (the
    ``stencil5-xla`` operator).  Summed left to right as the kernels sum it:
    C·x + W·xw + E·xe + N·xn + S·xs.  bf16 planes are widened exactly to x's dtype by
    PyTorch's type promotion."""
    xn, xs, xw, xe = _neighbours(x, halo_prev, halo_next)
    y = planes[C] * x + planes[W] * xw + planes[E] * xe + planes[N] * xn + planes[S] * xs
    y = y if out is None else out.copy_(y)
    return (y, _dot(x, y)) if with_dot else y


def spmv_stencil5_const_plain(x, halo_prev=None, halo_next=None, *, diag, offdiag,
                              with_dot=False, out=None):
    """Plain twin of ``spmv_stencil5_const``; the port of ``spmv_stencil5_const_xla``
    (the ``stencil5-const-xla`` operator).  Neighbour sum in the kernels' order
    ((N + S) + W) + E; diag and offdiag in x's dtype (rounded to bf16 for a bf16 state,
    as JAX rounds its Python floats)."""
    xn, xs, xw, xe = _neighbours(x, halo_prev, halo_next)
    d, o = (float(torch.tensor(v, dtype=x.dtype)) for v in (diag, offdiag))  # on the host
    y = d * x + o * (((xn + xs) + xw) + xe)
    y = y if out is None else out.copy_(y)
    return (y, _dot(x, y)) if with_dot else y


def spmv_stencil5_const_pupdate_dot_plain(beta, r, p, halo_prev=None, halo_next=None, *,
                                          diag, offdiag, out=None):
    """Plain twin of ``spmv_stencil5_const_pupdate_dot``: K10's twin without y."""
    pnew, _, dot = spmv_stencil5_const_pupdate_plain(beta, r, p, halo_prev, halo_next,
                                                     diag=diag, offdiag=offdiag, out=out)
    return pnew, dot


def _pupdate_plain(spmv, beta, r, p, out, y_out=None):
    """p' = r + β·p, y = spmv(p') and <p', y>, p' copied into ``out`` and y into ``y_out``
    when given."""
    pnew = r + scalar(beta, r) * p
    y = spmv(pnew)
    dot = _dot(pnew, y)
    if out is not None:
        _check_out(out, r, p)
        pnew = out.copy_(pnew)
    if y_out is not None:
        _check_y_out(y_out, r, p, pnew)
        y = y_out.copy_(y)
    return pnew, y, dot


def spmv_stencil5_pupdate_plain(planes, beta, r, p, halo_prev=None, halo_next=None, *,
                                out=None, y_out=None):
    """Plain twin of ``spmv_stencil5_pupdate``."""
    return _pupdate_plain(lambda f: spmv_stencil5_plain(planes, f, halo_prev, halo_next),
                          beta, r, p, out, y_out)


def spmv_stencil5_const_pupdate_plain(beta, r, p, halo_prev=None, halo_next=None, *, diag,
                                      offdiag, out=None, y_out=None):
    """Plain twin of ``spmv_stencil5_const_pupdate``."""
    return _pupdate_plain(lambda f: spmv_stencil5_const_plain(f, halo_prev, halo_next,
                                                              diag=diag, offdiag=offdiag),
                          beta, r, p, out, y_out)


def cg_const_update_recompute_plain(alpha, x, r, p, halo_prev=None, halo_next=None, *,
                                    diag, offdiag):
    """Plain twin of ``cg_const_update_recompute``: updates x and r in place, as the
    kernel does."""
    alpha = scalar(alpha, r)
    ap = spmv_stencil5_const_plain(p, halo_prev, halo_next, diag=diag, offdiag=offdiag)
    x.add_(alpha * p)
    r.sub_(alpha * ap)
    return x, r, _dot(r, r)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def spmv_stencil5(planes, x, halo_prev=None, halo_next=None, *, with_dot=False, out=None):
    """y = A·x for the coefficient planes (5, rows, g) in the order N, W, C, E, S, or
    (y, <x, A·x>) when ``with_dot``.  Planes are x's dtype, or bfloat16 (the
    ``stencil5-bf16c`` operator) for an f32 or f64 x; a bf16 x takes bf16 planes.  y goes
    into ``out`` when given (a field like x that overlaps neither x nor a halo row), else
    into a new field.

    Replaces the Pallas kernels ``spmv_stencil5_pipelined`` and ``spmv_stencil5_pallas``
    (tpusparse/kernels/stencil5.py): one CUDA kernel backs both, since they differ only in
    how the TPU moved data."""
    if x.device.type == "cpu":
        return spmv_stencil5_plain(planes, x, halo_prev, halo_next, with_dot=with_dot,
                                   out=out)
    rows, g = _check_band(x, x)
    _check_planes(planes, x)
    _check_halos(halo_prev, halo_next, x)
    y = _spmv_out(out, x, halo_prev, halo_next)
    dot, part = dot_buffers(x, _partials(rows, g)) if with_dot else (None, None)
    suffix = _PLANES_SUFFIX[planes.dtype] + SUFFIX[x.dtype]
    fn = getattr(_build.lib(), f"tps_spmv_stencil5_{suffix}")
    _build.check(fn(planes.data_ptr(), x.data_ptr(), ptr(halo_prev), ptr(halo_next),
                    y.data_ptr(), rows, g, ptr(part), ptr(dot), stream(x)),
                 "spmv_stencil5")
    LAUNCHES["spmv_stencil5"] += 1
    return (y, dot) if with_dot else y


def spmv_stencil5_pupdate(planes, beta, r, p, halo_prev=None, halo_next=None, *, out=None,
                          y_out=None):
    """(p', A·p', <p', A·p'>) with p' = r + β·p and the coefficient planes of
    ``spmv_stencil5``: the fused top of a CG iteration.  β = 0 with p = 0 gives the first
    iteration (p' = r).

    Replaces the Pallas kernel ``spmv_stencil5_pupdate_pipelined``.  p' never overwrites
    p: pass ``out`` (a field that overlaps neither r nor p) to reuse a buffer, else a new
    one is allocated; y goes into ``y_out`` (a field that overlaps none of r, p and p')
    when given, else into a new field.  Halo rows are the neighbours' p' rows."""
    if r.device.type == "cpu":
        return spmv_stencil5_pupdate_plain(planes, beta, r, p, halo_prev, halo_next, out=out,
                                           y_out=y_out)
    rows, g = _check_band(r, r)
    check_state(r, "spmv_stencil5_pupdate (K9)")
    check_field(p, r)
    _check_planes(planes, r)
    _check_halos(halo_prev, halo_next, r)
    out = _pupdate_out(out, r, p)
    y = _pupdate_y(y_out, r, p, out)
    beta = scalar(beta, r)
    dot, part = dot_buffers(r, _partials(rows, g))
    suffix = _PLANES_SUFFIX[planes.dtype] + SUFFIX[r.dtype]
    fn = getattr(_build.lib(), f"tps_spmv_stencil5_pupdate_{suffix}")
    _build.check(fn(beta.data_ptr(), planes.data_ptr(), r.data_ptr(), p.data_ptr(),
                    ptr(halo_prev), ptr(halo_next), out.data_ptr(), y.data_ptr(), rows, g,
                    part.data_ptr(), dot.data_ptr(), stream(r)),
                 "spmv_stencil5_pupdate")
    LAUNCHES["spmv_stencil5_pupdate"] += 1
    return out, y, dot


def const_vector_fits(x, halo_prev=None, halo_next=None, out=None, *, fields=()) -> bool:
    """Whether a vector body takes these operands: a contiguous 2-D field x of f32, f64 or
    bf16 whose rows are whole 16-byte vectors (g·itemsize a multiple of 16), and x, the
    halo rows, ``out`` and the further ``fields`` of the launch (each when given: K1's p,
    K2's x and p beside r) contiguous and 16-byte aligned.  Then every row of every field
    starts on a 16-byte boundary.  A plain function of shapes, strides and addresses: it
    holds for CPU tensors too."""
    if x.dim() != 2 or x.dtype not in SUFFIX or x.shape[1] * x.element_size() % 16:
        return False
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, halo_prev, halo_next, out, *fields) if t is not None)


def spmv_stencil5_const(x, halo_prev=None, halo_next=None, *, diag, offdiag,
                        with_dot=False, out=None, _scalar_body=False):
    """y = A·x, or (y, <x, A·x>) when ``with_dot``; ``out`` as in ``spmv_stencil5``.

    Replaces the Pallas kernels ``spmv_stencil5_const_pipelined`` and
    ``spmv_stencil5_const_pallas`` (tpusparse/kernels/stencil5.py): one CUDA wrapper backs
    both, since they differ only in how the TPU moved data.  On a card it launches the
    vector body when ``const_vector_fits(x, halo_prev, halo_next, y)`` holds (y: ``out``
    or the new field), else the scalar body: the rule is alignment, never a failure, and
    an error of either body raises.  Both give the same y bit for bit; the vector body's
    dot is summed in its own fixed order, in one launch.  ``_scalar_body=True`` forces the
    scalar body (for tests and timings that hold the two side by side)."""
    if x.device.type == "cpu":
        return spmv_stencil5_const_plain(x, halo_prev, halo_next, diag=diag, offdiag=offdiag,
                                         with_dot=with_dot, out=out)
    rows, g = _check_band(x, x)
    _check_halos(halo_prev, halo_next, x)
    y = _spmv_out(out, x, halo_prev, halo_next)
    s = stream(x)
    if not _scalar_body and const_vector_fits(x, halo_prev, halo_next, y):
        stack = VEC_STACK[bool(with_dot)]
        dot, part = (dot_buffers(x, _vec_partials(rows, g, x.element_size(), stack))
                     if with_dot else (None, None))
        fn = getattr(_build.lib(), f"tps_spmv_stencil5_const_vec_{SUFFIX[x.dtype]}")
        _build.check(fn(x.data_ptr(), ptr(halo_prev), ptr(halo_next), y.data_ptr(), rows, g,
                        stack, float(diag), float(offdiag), ptr(part),
                        ptr(dot_tickets(x, s)) if with_dot else None, ptr(dot), s),
                     "spmv_stencil5_const (vector body)")
    else:
        dot, part = dot_buffers(x, _partials(rows, g)) if with_dot else (None, None)
        fn = getattr(_build.lib(), f"tps_spmv_stencil5_const_{SUFFIX[x.dtype]}")
        _build.check(fn(x.data_ptr(), ptr(halo_prev), ptr(halo_next), y.data_ptr(), rows, g,
                        float(diag), float(offdiag), ptr(part), ptr(dot), s),
                     "spmv_stencil5_const (scalar body)")
        LAUNCHES["spmv_stencil5_const_scalar"] += 1
    LAUNCHES["spmv_stencil5_const"] += 1
    return (y, dot) if with_dot else y


def spmv_stencil5_const_pupdate_dot(beta, r, p, halo_prev=None, halo_next=None, *, diag,
                                    offdiag, out=None, _scalar_body=False):
    """(p', <p', A·p'>) with p' = r + β·p; A·p' is formed in registers and never stored.

    Replaces the Pallas kernel ``spmv_stencil5_const_pupdate_dot_pipelined``.  Unlike it,
    p' never overwrites p: pass ``out`` (a field that overlaps neither r nor p) to reuse
    a buffer, else a new one is allocated.  Halo rows are the neighbours' p' rows.  The
    body as in ``spmv_stencil5_const``: the vector body when ``const_vector_fits(r,
    halo_prev, halo_next, out, fields=(p,))`` holds, else the scalar body; both give p'
    bit for bit, each its own fixed order of the dot."""
    if r.device.type == "cpu":
        return spmv_stencil5_const_pupdate_dot_plain(beta, r, p, halo_prev, halo_next,
                                                     diag=diag, offdiag=offdiag, out=out)
    rows, g = _check_band(r, r)
    check_state(r, "spmv_stencil5_const_pupdate_dot (K1)")
    check_field(p, r)
    _check_halos(halo_prev, halo_next, r)
    out = _pupdate_out(out, r, p)
    beta = scalar(beta, r)
    s = stream(r)
    if not _scalar_body and const_vector_fits(r, halo_prev, halo_next, out, fields=(p,)):
        stack = VEC_STACK[True]
        dot, part = dot_buffers(r, _vec_partials(rows, g, r.element_size(), stack))
        fn = getattr(_build.lib(), f"tps_stencil5_const_pupdate_dot_vec_{SUFFIX[r.dtype]}")
        _build.check(fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), ptr(halo_prev),
                        ptr(halo_next), out.data_ptr(), rows, g, stack, float(diag),
                        float(offdiag), part.data_ptr(), dot_tickets(r, s).data_ptr(),
                        dot.data_ptr(), s),
                     "spmv_stencil5_const_pupdate_dot (vector body)")
    else:
        dot, part = dot_buffers(r, _partials(rows, g))
        fn = getattr(_build.lib(), f"tps_stencil5_const_pupdate_dot_{SUFFIX[r.dtype]}")
        _build.check(fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), ptr(halo_prev),
                        ptr(halo_next), out.data_ptr(), rows, g, float(diag), float(offdiag),
                        part.data_ptr(), dot.data_ptr(), s),
                     "spmv_stencil5_const_pupdate_dot (scalar body)")
        LAUNCHES["spmv_stencil5_const_pupdate_dot_scalar"] += 1
    LAUNCHES["spmv_stencil5_const_pupdate_dot"] += 1
    return out, dot


def spmv_stencil5_const_pupdate(beta, r, p, halo_prev=None, halo_next=None, *, diag,
                                offdiag, out=None, y_out=None):
    """(p', A·p', <p', A·p'>) with p' = r + β·p: ``spmv_stencil5_pupdate`` for the
    constant stencil, and K1 with A·p' stored.

    Replaces the Pallas kernel ``spmv_stencil5_const_pupdate_pipelined``.  ``out``,
    ``y_out`` and the halo rows as in ``spmv_stencil5_pupdate``."""
    if r.device.type == "cpu":
        return spmv_stencil5_const_pupdate_plain(beta, r, p, halo_prev, halo_next, diag=diag,
                                                 offdiag=offdiag, out=out, y_out=y_out)
    rows, g = _check_band(r, r)
    check_state(r, "spmv_stencil5_const_pupdate (K10)")
    check_field(p, r)
    _check_halos(halo_prev, halo_next, r)
    out = _pupdate_out(out, r, p)
    y = _pupdate_y(y_out, r, p, out)
    beta = scalar(beta, r)
    dot, part = dot_buffers(r, _partials(rows, g))
    fn = getattr(_build.lib(), f"tps_stencil5_const_pupdate_spmv_{SUFFIX[r.dtype]}")
    _build.check(fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), ptr(halo_prev),
                    ptr(halo_next), out.data_ptr(), y.data_ptr(), rows, g, float(diag),
                    float(offdiag), part.data_ptr(), dot.data_ptr(), stream(r)),
                 "spmv_stencil5_const_pupdate")
    LAUNCHES["spmv_stencil5_const_pupdate"] += 1
    return out, y, dot


def cg_const_update_recompute(alpha, x, r, p, halo_prev=None, halo_next=None, *, diag,
                              offdiag, _scalar_body=False):
    """(x, r, <r, r>) after x += α·p and r -= α·A·p, in place; A·p is recomputed from p.

    Replaces the Pallas kernel ``cg_const_update_recompute_pipelined``.  Halo rows are the
    neighbours' p rows.  p must overlap neither x nor r.  The body as in
    ``spmv_stencil5_const``: the vector body when ``const_vector_fits(r, halo_prev,
    halo_next, fields=(x, p))`` holds, else the scalar body; both give x and r bit for
    bit, each its own fixed order of the dot."""
    if r.device.type == "cpu":
        return cg_const_update_recompute_plain(alpha, x, r, p, halo_prev, halo_next,
                                               diag=diag, offdiag=offdiag)
    rows, g = _check_band(r, r)
    check_state(r, "cg_const_update_recompute (K2)")
    check_field(x, r)
    check_field(p, r)
    check_apart({"x": x, "r": r}, {"p": p})
    _check_halos(halo_prev, halo_next, r)
    alpha = scalar(alpha, r)
    s = stream(r)
    if not _scalar_body and const_vector_fits(r, halo_prev, halo_next, fields=(x, p)):
        stack = UPDATE_VEC_STACK
        dot, part = dot_buffers(r, _vec_partials(rows, g, r.element_size(), stack))
        fn = getattr(_build.lib(), f"tps_cg_const_update_recompute_vec_{SUFFIX[r.dtype]}")
        _build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                        ptr(halo_prev), ptr(halo_next), rows, g, stack, float(diag),
                        float(offdiag), part.data_ptr(), dot_tickets(r, s).data_ptr(),
                        dot.data_ptr(), s),
                     "cg_const_update_recompute (vector body)")
    else:
        dot, part = dot_buffers(r, _partials(rows, g))
        fn = getattr(_build.lib(), f"tps_cg_const_update_recompute_{SUFFIX[r.dtype]}")
        _build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                        ptr(halo_prev), ptr(halo_next), rows, g, float(diag), float(offdiag),
                        part.data_ptr(), dot.data_ptr(), s),
                     "cg_const_update_recompute (scalar body)")
        LAUNCHES["cg_const_update_recompute_scalar"] += 1
    LAUNCHES["cg_const_update_recompute"] += 1
    return x, r, dot


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check_band(t, like):
    """A (rows, g) CUDA field (``_launch.check_field``) that one launch covers."""
    check_field(t, like)
    if t.dim() != 2:
        raise ValueError(f"expected a 2-D field, got shape {tuple(t.shape)}")
    rows, g = t.shape
    max_rows = _max_rows()
    if rows > max_rows:
        raise ValueError(f"band of {rows} rows exceeds one launch's {max_rows}")
    return rows, g


def _check_planes(planes, x):
    rows, g = x.shape
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device}, x on {x.device}")
    if planes.dtype not in (x.dtype, torch.bfloat16):
        raise ValueError(f"planes of dtype {planes.dtype} for a {x.dtype} field: the kernel "
                         "takes planes in the field's dtype or bfloat16")
    if tuple(planes.shape) != (5, rows, g) or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous (5, {rows}, {g}), got "
                         f"{tuple(planes.shape)}")


def _check_halos(halo_prev, halo_next, like):
    g = like.shape[1]
    for h in (halo_prev, halo_next):
        if h is None:
            continue
        if h.device != like.device or h.dtype != like.dtype:
            raise ValueError("halo rows must match the field's device and dtype")
        if h.numel() != g or not h.is_contiguous():
            raise ValueError(f"halo rows must be contiguous (1, {g}), got {tuple(h.shape)}")


def _check_out(out, r, p):
    for name, t in (("r", r), ("p", p)):
        if overlaps(out, t):
            raise ValueError(f"out must not overlap {name}: neighbouring blocks still read "
                             f"{name} while p' is written")


def _spmv_out(out, x, halo_prev, halo_next):
    """The y of K3 and K8: ``out`` once checked, else a new field."""
    if out is None:
        return torch.empty_like(x)
    check_field(out, x)
    for name, t in (("x", x), ("halo_prev", halo_prev), ("halo_next", halo_next)):
        if t is not None and overlaps(out, t):
            raise ValueError(f"out must not overlap {name}: the kernel reads it while y is "
                             "written")
    return out


def _pupdate_out(out, r, p):
    """The p' buffer of K1, K9 and K10: ``out`` once checked, else a new field."""
    if out is None:
        return torch.empty_like(r)
    check_field(out, r)
    _check_out(out, r, p)
    return out


def _check_y_out(y_out, r, p, pnew):
    for name, t in (("r", r), ("p", p), ("p'", pnew)):
        if overlaps(y_out, t):
            raise ValueError(f"y_out must not overlap {name}: the kernel reads or writes it "
                             "while y is written")


def _pupdate_y(y_out, r, p, pnew):
    """The y of K9 and K10: ``y_out`` once checked, else a new field."""
    if y_out is None:
        return torch.empty_like(r)
    check_field(y_out, r)
    _check_y_out(y_out, r, p, pnew)
    return y_out


# the library's size queries, asked once per library and shape so that a launch makes
# one foreign call, the kernel's own
@functools.lru_cache(maxsize=None)
def _max_rows():
    return _build.lib().tps_stencil5_max_rows()


@functools.lru_cache(maxsize=64)
def _partials(rows, g):
    return _build.lib().tps_stencil5_partials(rows, g)


@functools.lru_cache(maxsize=64)
def _vec_partials(rows, g, elem_size, stack):
    return _build.lib().tps_spmv_stencil5_const_vec_partials(rows, g, elem_size, stack)

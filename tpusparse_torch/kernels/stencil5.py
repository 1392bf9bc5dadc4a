"""Constant-coefficient 5-point stencil passes: CUDA kernels and their plain PyTorch twins.

Counterpart of ``tpusparse/kernels/stencil5.py`` for the values-free operator
y = diag·x + offdiag·(N + S + W + E) on a (rows, g) row band.  N/S of the band's first and
last rows come from the optional (1, g) halo rows (``None`` = zero, the grid edge); W/E at
the side columns are zero.  Three wrappers, one per Pallas kernel of the CG solve's path:

  ``spmv_stencil5_const``              K3, y = A·x and optionally <x, A·x>
  ``spmv_stencil5_const_pupdate_dot``  K1, recompute-CG pass A: p' = r + β·p, <p', A·p'>
  ``cg_const_update_recompute``        K2, recompute-CG pass B: x += α·p, r -= α·A·p, <r, r>

Each has a ``*_plain`` twin of the same signature in plain PyTorch.  A wrapper given CPU
tensors runs the twin; given CUDA tensors it launches the kernel from
``tpusparse_torch/csrc/stencil5_const.cu`` or raises; there is no fallback between the two.
Kernel and twin round every field operation alike, so their fields agree bit for bit; the
dots differ only in summation order.  Dots come back as 0-d tensors in the state's dtype;
α and β are 0-d tensors (or Python floats) that the kernels read through a device pointer.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (twins do not count).
"""

from __future__ import annotations

import functools

import torch

from .. import _build

LAUNCHES = {
    "spmv_stencil5_const": 0,
    "spmv_stencil5_const_pupdate_dot": 0,
    "cg_const_update_recompute": 0,
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def spmv_stencil5_const_plain(x, halo_prev=None, halo_next=None, *, diag, offdiag,
                              with_dot=False):
    """Plain twin of ``spmv_stencil5_const``; the port of ``spmv_stencil5_const_xla``
    (the ``stencil5-const-xla`` operator).  Neighbour sum in the kernels' order
    ((N + S) + W) + E."""
    rows, g = x.shape
    zrow = x.new_zeros((1, g))
    top = zrow if halo_prev is None else halo_prev.reshape(1, g)
    bot = zrow if halo_next is None else halo_next.reshape(1, g)
    zcol = x.new_zeros((rows, 1))
    xn = torch.cat([top, x[:-1]], 0)
    xs = torch.cat([x[1:], bot], 0)
    xw = torch.cat([zcol, x[:, :-1]], 1)
    xe = torch.cat([x[:, 1:], zcol], 1)
    y = diag * x + offdiag * (((xn + xs) + xw) + xe)
    return (y, _dot(x, y)) if with_dot else y


def spmv_stencil5_const_pupdate_dot_plain(beta, r, p, halo_prev=None, halo_next=None, *,
                                          diag, offdiag, out=None):
    """Plain twin of ``spmv_stencil5_const_pupdate_dot``."""
    beta = _scalar(beta, r)
    pnew = r + beta * p
    y = spmv_stencil5_const_plain(pnew, halo_prev, halo_next, diag=diag, offdiag=offdiag)
    dot = _dot(pnew, y)
    if out is not None:
        _check_out(out, r, p)
        pnew = out.copy_(pnew)
    return pnew, dot


def cg_const_update_recompute_plain(alpha, x, r, p, halo_prev=None, halo_next=None, *,
                                    diag, offdiag):
    """Plain twin of ``cg_const_update_recompute``: updates x and r in place, as the
    kernel does."""
    alpha = _scalar(alpha, r)
    ap = spmv_stencil5_const_plain(p, halo_prev, halo_next, diag=diag, offdiag=offdiag)
    x.add_(alpha * p)
    r.sub_(alpha * ap)
    return x, r, _dot(r, r)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def spmv_stencil5_const(x, halo_prev=None, halo_next=None, *, diag, offdiag,
                        with_dot=False):
    """y = A·x, or (y, <x, A·x>) when ``with_dot``.

    Replaces the Pallas kernels ``spmv_stencil5_const_pipelined`` and
    ``spmv_stencil5_const_pallas`` (tpusparse/kernels/stencil5.py): one CUDA kernel backs
    both, since they differ only in how the TPU moved data."""
    if x.device.type == "cpu":
        return spmv_stencil5_const_plain(x, halo_prev, halo_next, diag=diag, offdiag=offdiag,
                                         with_dot=with_dot)
    rows, g = _check_field(x, x)
    _check_halos(halo_prev, halo_next, x)
    y = torch.empty_like(x)
    dot, part = _dot_buffers(x, rows, g) if with_dot else (None, None)
    lib = _build.lib()
    fn = getattr(lib, f"tps_spmv_stencil5_const_{_SUFFIX[x.dtype]}")
    _build.check(fn(x.data_ptr(), _ptr(halo_prev), _ptr(halo_next), y.data_ptr(), rows, g,
                    float(diag), float(offdiag), _ptr(part), _ptr(dot), _stream(x)),
                 "spmv_stencil5_const")
    LAUNCHES["spmv_stencil5_const"] += 1
    return (y, dot) if with_dot else y


def spmv_stencil5_const_pupdate_dot(beta, r, p, halo_prev=None, halo_next=None, *, diag,
                                    offdiag, out=None):
    """(p', <p', A·p'>) with p' = r + β·p; A·p' is formed in registers and never stored.

    Replaces the Pallas kernel ``spmv_stencil5_const_pupdate_dot_pipelined``.  Unlike it,
    p' never overwrites p: pass ``out`` (a field that overlaps neither r nor p) to reuse
    a buffer, else a new one is allocated.  Halo rows are the neighbours' p' rows."""
    if r.device.type == "cpu":
        return spmv_stencil5_const_pupdate_dot_plain(beta, r, p, halo_prev, halo_next,
                                                     diag=diag, offdiag=offdiag, out=out)
    rows, g = _check_field(r, r)
    _check_field(p, r)
    _check_halos(halo_prev, halo_next, r)
    if out is None:
        out = torch.empty_like(r)
    else:
        _check_field(out, r)
        _check_out(out, r, p)
    beta = _scalar(beta, r)
    dot, part = _dot_buffers(r, rows, g)
    lib = _build.lib()
    fn = getattr(lib, f"tps_stencil5_const_pupdate_dot_{_SUFFIX[r.dtype]}")
    _build.check(fn(beta.data_ptr(), r.data_ptr(), p.data_ptr(), _ptr(halo_prev),
                    _ptr(halo_next), out.data_ptr(), rows, g, float(diag), float(offdiag),
                    part.data_ptr(), dot.data_ptr(), _stream(r)),
                 "spmv_stencil5_const_pupdate_dot")
    LAUNCHES["spmv_stencil5_const_pupdate_dot"] += 1
    return out, dot


def cg_const_update_recompute(alpha, x, r, p, halo_prev=None, halo_next=None, *, diag,
                              offdiag):
    """(x, r, <r, r>) after x += α·p and r -= α·A·p, in place; A·p is recomputed from p.

    Replaces the Pallas kernel ``cg_const_update_recompute_pipelined``.  Halo rows are the
    neighbours' p rows.  p must overlap neither x nor r."""
    if r.device.type == "cpu":
        return cg_const_update_recompute_plain(alpha, x, r, p, halo_prev, halo_next,
                                               diag=diag, offdiag=offdiag)
    rows, g = _check_field(r, r)
    _check_field(x, r)
    _check_field(p, r)
    if len({x.data_ptr(), r.data_ptr(), p.data_ptr()}) != 3:
        raise ValueError("cg_const_update_recompute: x, r and p must be distinct buffers")
    _check_halos(halo_prev, halo_next, r)
    alpha = _scalar(alpha, r)
    dot, part = _dot_buffers(r, rows, g)
    lib = _build.lib()
    fn = getattr(lib, f"tps_cg_const_update_recompute_{_SUFFIX[r.dtype]}")
    _build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                    _ptr(halo_prev), _ptr(halo_next), rows, g, float(diag), float(offdiag),
                    part.data_ptr(), dot.data_ptr(), _stream(r)),
                 "cg_const_update_recompute")
    LAUNCHES["cg_const_update_recompute"] += 1
    return x, r, dot


# ---------------------------------------------------------------------------
# Checks and launch plumbing
# ---------------------------------------------------------------------------


def _check_field(t, like):
    """A contiguous (rows, g) CUDA field of f32/f64 on ``like``'s device and dtype."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor (or CPU for the plain twin), got "
                         f"device {t.device}")
    if t.dtype not in _SUFFIX:
        raise ValueError(f"unsupported dtype {t.dtype}: the kernels take float32/float64")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"tensors disagree: {t.device}/{t.dtype} vs "
                         f"{like.device}/{like.dtype}")
    if t.dim() != 2 or t.shape != like.shape:
        raise ValueError(f"expected a 2-D field of shape {tuple(like.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("fields must be contiguous")
    rows, g = t.shape
    if rows < 1 or g < 1:
        raise ValueError(f"empty field {tuple(t.shape)}")
    max_rows = _max_rows()
    if rows > max_rows:
        raise ValueError(f"band of {rows} rows exceeds one launch's {max_rows}")
    return rows, g


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
        if out.data_ptr() == t.data_ptr():
            raise ValueError(f"out must not overlap {name}: neighbouring blocks still read "
                             f"{name} while p' is written")


def _scalar(v, like):
    """α/β as a 0-d tensor on ``like``'s device and dtype (a no-op when it already is)."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(())


# the library's size queries, asked once per library and shape so that a launch makes
# one foreign call, the kernel's own
@functools.lru_cache(maxsize=None)
def _max_rows():
    return _build.lib().tps_stencil5_max_rows()


@functools.lru_cache(maxsize=64)
def _partials(rows, g):
    return _build.lib().tps_stencil5_partials(rows, g)


def _dot_buffers(like, rows, g):
    n = _partials(rows, g)
    return (torch.empty((), dtype=like.dtype, device=like.device),
            torch.empty(n, dtype=like.dtype, device=like.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream

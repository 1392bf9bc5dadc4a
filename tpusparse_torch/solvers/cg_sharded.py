"""Row-band sharded Conjugate Gradient of the port: the 1-D half of
``tpusparse/solvers/cg_sharded.py`` (reference ``cg_solve_mgpu_partitioned``,
src/solvers/cg_solver_mgpu_partitioned.cu:236-908).

  reference (CUDA + MPI)            JAX package                   this port
  --------------------------------  ----------------------------  ---------------------------
  1 MPI rank = 1 GPU                1-D mesh, one process/host    1 gloo rank = 1 process on
                                                                  one device (``dist``)
  row bands n/P (+ remainder)       rows sharded P("x"), zero     the same bands, (−g mod P)
                                    pad rows                      zero pad rows at the end
  pinned-host staged halo           ``ppermute`` of one row       pinned-host staged: D2H,
    (D2H -> MPI -> H2D, :173-231)     per neighbour                 gloo isend/irecv, H2D
  cublasDdot + MPI_Allreduce        local dot + ``psum``          the kernel's local dot,
                                                                  D2H, gloo all_gather,
                                                                  summed in rank order
  MPI_Gatherv of x (:834-851)       out_spec resharding           ``dist.gather_to_host``

gloo takes CPU tensors only, so the halo rows and the dots pass through the host, as the
reference's did; NCCL, which would move them from device to device, refuses two ranks on
one card.  Each rank's partial dot goes to its host, gloo gathers the N partials, and every
rank adds them in rank order in the partials' dtype: every rank holds the same bits, and
the sum is the same on every run (an ``all_reduce`` would add them in the transport's
order).  α and β go back to the device as 0-d tensors, which the kernels read through a
device pointer.  So the loops are host-stepped by nature: two reads a iteration, where
``cg.cg_solve`` reads one flag.

Kernels, all with the halo rows as pointers (``kernels.stencil5``, ``kernels.ell``):

  - ``stencil5``, ``stencil5-bf16c``: K8 over the band's coefficient planes;
  - ``stencil5-const``: K3, or in the recompute loop (its default) K1 and K2;
  - ``csr``: the ELL kernel (K12/K13's), rectangular, over a gather domain of the band
    with a halo row on either side, (band + 2)·g entries whose middle rows are p itself;
  - the classic loop's K4 and K5, and K6 for <r0, r0> and the stepped loop's dots.

``HALO_CALLS`` counts the exchanges and, by wrapper, the calls whose halo row is one that
an exchange received (not a row of the band itself, not an edge's zero row).

The overlapped SpMV (``overlap=True`` with more than one rank and bands of 3 rows or more,
the JAX package's ``_spmv_dot_overlapped``): the boundary rows' D2H copy is queued, then
the interior rows' kernel, and only then does the host wait for the copy, exchange the
rows by gloo and copy the halos back, while the card runs the interior; the two boundary
rows follow as kernels of one row each.  The planes of a band are kept as three
contiguous pieces (first row, interior, last row) so that each kernel reads its own rows'
planes; y of each piece goes straight into its rows of one y.  Every row is computed by
the same kernel arithmetic either way, so the overlapped y equals the synchronous y bit
for bit; only the dot's sum is grouped differently.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist, formats
from .._device import resolve_device, resolve_dtype
from ..bench import profiling
from ..generate import (make_stencil5, make_stencil5_ell_device, make_stencil5_planes_device,
                        ones_band, stencil5_ell_device_ok, stencil5_nnz)
from ..kernels import blas1
from ..kernels import ell as _ell
from ..kernels import stencil5 as _st5
from .cg import CGConfig, CGStats

MODES = ("stencil5", "stencil5-bf16c", "stencil5-const", "csr")

# the exchanges that received a neighbour's row ("exchange"), and by wrapper the calls given
# a row that an exchange received (on a card each call is one launch of its kernel): they
# show that the halo rows a kernel read came from a neighbour, not from the band or an edge
HALO_CALLS = dict.fromkeys(("exchange", "spmv_stencil5", "spmv_stencil5_const",
                            "spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute",
                            "spmv_ell"), 0)


def reset_halo_calls() -> None:
    for name in HALO_CALLS:
        HALO_CALLS[name] = 0


class _HaloExchange:
    """One rank's boundary-row exchange with its band neighbours (the JAX package's
    ``_band_halo_exchange``), staged through pinned host buffers as the reference staged
    it: ``start`` queues the D2H copy of the rows to send, ``finish`` waits for it, swaps
    rows with both neighbours by gloo and copies the received rows to the device.  A rank
    at the grid's edge gets None for the missing neighbour's row: a zero row, the
    Dirichlet boundary as data, as ``ppermute`` zero-filled."""

    def __init__(self, g, dtype, device, out_prev=None, out_next=None):
        r, n = dist.rank(), dist.world_size()
        self.prev = r - 1 if r > 0 else None
        self.next = r + 1 if r < n - 1 else None
        cuda = device.type == "cuda"
        self.send = torch.empty((2, g), dtype=dtype, pin_memory=cuda)
        self.recv = torch.empty((2, g), dtype=dtype, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

        def dev_row(out):
            return out if out is not None else torch.zeros((1, g), dtype=dtype, device=device)

        self.halo_prev = dev_row(out_prev) if self.prev is not None else None
        self.halo_next = dev_row(out_next) if self.next is not None else None

    def start(self, first, last):
        """Queue the D2H copy of ``first`` (for the previous rank) and ``last`` (for the
        next)."""
        if self.prev is None and self.next is None:
            return
        with profiling.scope(profiling.PHASE_HALO):
            self.send[0].copy_(first.reshape(-1), non_blocking=True)
            self.send[1].copy_(last.reshape(-1), non_blocking=True)
            if self.event is not None:
                self.event.record()

    def finish(self):
        """(halo_prev, halo_next) on the device, each (1, g) or None at the grid's edge."""
        if self.prev is None and self.next is None:
            return None, None
        with profiling.scope(profiling.PHASE_HALO):
            if self.event is not None:
                self.event.synchronize()
            ops = []
            if self.prev is not None:
                ops += [tdist.P2POp(tdist.isend, self.send[0], self.prev),
                        tdist.P2POp(tdist.irecv, self.recv[0], self.prev)]
            if self.next is not None:
                ops += [tdist.P2POp(tdist.isend, self.send[1], self.next),
                        tdist.P2POp(tdist.irecv, self.recv[1], self.next)]
            for req in tdist.batch_isend_irecv(ops):
                req.wait()
            HALO_CALLS["exchange"] += 1
            if self.halo_prev is not None:
                self.halo_prev.copy_(self.recv[0].reshape(1, -1), non_blocking=True)
            if self.halo_next is not None:
                self.halo_next.copy_(self.recv[1].reshape(1, -1), non_blocking=True)
        return self.halo_prev, self.halo_next

    def count(self, name, *rows) -> None:
        """Count a call of wrapper ``name`` if one of ``rows`` is a row this exchange
        received."""
        got = [h for h in (self.halo_prev, self.halo_next) if h is not None]
        if any(row is h for row in rows for h in got):
            HALO_CALLS[name] += 1

    def exchange(self, field):
        """The halos of a (rows, g) field: its first row goes to the previous rank, its
        last to the next."""
        self.start(field[0], field[-1])
        return self.finish()


def _allsum(local):
    """The sum over the ranks of each rank's partial (a 0-d tensor on its device), as a
    0-d CPU tensor in the partial's dtype: gloo gathers the partials and every rank adds
    them in rank order, so every rank holds the same bits."""
    with profiling.annotate(profiling.PHASE_DOT):
        host = local.detach().reshape(1).to("cpu")
        n = dist.world_size()
        if n == 1:
            return host.reshape(())
        parts = [torch.empty_like(host) for _ in range(n)]
        tdist.all_gather(parts, host)
        total = parts[0].clone()
        for t in parts[1:]:
            total += t
        return total.reshape(())


def _on(t, device, dtype):
    """A host 0-d tensor as a 0-d tensor on the device: a fill, no host sync."""
    return torch.full((), float(t), dtype=dtype, device=device)


@dataclasses.dataclass(eq=False)
class ShardedOperator:
    """This rank's part of the row-band sharded operator: the sharded counterpart of
    ``ops.DeviceOperator`` and of the JAX package's ``ShardedOperator``.

    Every rank holds ``band`` rows, global rows [row_lo, row_lo + band) of the grid padded
    with ``row_pad`` zero rows to a multiple of the ranks.  ``pieces`` cover the band's
    rows, ((r0, r1, planes of rows [r0, r1) or None), ...): one piece, or three when the
    SpMV overlaps its halo exchange.  ``csr``: ``ell_vals``/``ell_cols`` (W, band·g), the
    columns rebased into ``domain``, the (band + 2, g) gather domain whose middle rows are
    the p the solver updates (``p_buffer``)."""

    grid_size: int
    mode: str
    diag: float
    offdiag: float
    dtype: torch.dtype
    device: torch.device
    band: int
    row_lo: int
    row_pad: int
    overlap: bool
    halo: _HaloExchange
    pieces: tuple = ()
    ell_vals: Optional[torch.Tensor] = None
    ell_cols: Optional[torch.Tensor] = None
    domain: Optional[torch.Tensor] = None
    nnz_actual: int = 0

    @property
    def nnz(self) -> int:
        return self.nnz_actual or stencil5_nnz(self.grid_size)

    @property
    def num_rows(self) -> int:
        return self.grid_size * self.grid_size

    num_cols = num_rows

    @property
    def overlapped(self) -> bool:
        return len(self.pieces) == 3

    @property
    def field_shape(self) -> tuple:
        return (self.band, self.grid_size)

    def ones_b(self):
        """This rank's band of b = ones: zero on the pad rows (they are decoupled)."""
        g = self.grid_size
        lo, hi, pad = _real_rows(self.row_lo, self.row_lo + self.band, g)
        return ones_band(g, (lo, hi), pad, dtype=self.dtype, device=self.device)

    def band_of(self, field):
        """This rank's rows of a whole (g, g) field (numpy or tensor), pad rows zero."""
        g = self.grid_size
        lo, hi, pad = _real_rows(self.row_lo, self.row_lo + self.band, g)
        t = torch.as_tensor(np.asarray(field) if not torch.is_tensor(field) else field)
        if tuple(t.shape) != (g, g):
            raise ValueError(f"b must be a ({g}, {g}) field, got {tuple(t.shape)}")
        out = torch.zeros(self.field_shape, dtype=self.dtype, device=self.device)
        out[:hi - lo] = t[lo:hi].to(device=self.device, dtype=self.dtype)
        return out

    def p_buffer(self):
        """A field for the classic loop's p: for ``csr`` the middle rows of the gather
        domain, so that its halo rows arrive around it and no copy is made."""
        if self.domain is not None:
            return self.domain[1:-1]
        return torch.empty(self.field_shape, dtype=self.dtype, device=self.device)

    def local_spmv(self, p, hp, hn, *, with_dot=False):
        """The band's y = A·p with the halo rows provided (None = zero): compute only, no
        collective; (y, the local <p, y>) when ``with_dot``."""
        if self.mode == "csr":
            return self._ell_band_spmv(p, hp, hn, with_dot)
        y = torch.empty_like(p)
        dots = [self._rows(p, piece, hp, hn, y, with_dot) for piece in self.pieces]
        return (y, _sum_in_order(dots)) if with_dot else y

    def local_spmv_dot(self, p):
        """The band's y = A·p with the halo exchange, and the global <p, A·p> as a 0-d
        CPU tensor (every rank the same bits)."""
        if self.mode == "csr":
            hp, hn = self.halo.exchange(p)
            y, d = self._ell_band_spmv(p, hp, hn, True)
            return y, _allsum(d)
        if not self.overlapped:
            hp, hn = self.halo.exchange(p)
            y, d = self.local_spmv(p, hp, hn, with_dot=True)
            return y, _allsum(d)
        return self._spmv_dot_overlapped(p)

    def _spmv_dot_overlapped(self, p):
        """The boundary rows' D2H copy, then the interior rows' kernel (their halos are the
        band's own first and last rows), then the exchange while the card runs it, then
        the two boundary rows' kernels with the exchanged halos."""
        top, core, bottom = self.pieces
        self.halo.start(p[0], p[-1])
        y = torch.empty_like(p)
        d_core = self._rows(p, core, None, None, y, True)
        hp, hn = self.halo.finish()
        d_top = self._rows(p, top, hp, hn, y, True)
        d_bottom = self._rows(p, bottom, hp, hn, y, True)
        return y, _allsum(_sum_in_order([d_core, d_top, d_bottom]))

    def _rows(self, p, piece, hp, hn, y, with_dot):
        """K8 (planes) or K3 over the band's rows [r0, r1) into y's rows; the rows above
        and below come from p itself inside the band, else from the halo rows."""
        r0, r1, planes = piece
        above = hp if r0 == 0 else p[r0 - 1:r0]
        below = hn if r1 == self.band else p[r1:r1 + 1]
        if planes is not None:
            name = "spmv_stencil5"
            out = _st5.spmv_stencil5(planes, p[r0:r1], above, below, with_dot=with_dot,
                                     out=y[r0:r1])
        else:
            name = "spmv_stencil5_const"
            out = _st5.spmv_stencil5_const(p[r0:r1], above, below, diag=self.diag,
                                           offdiag=self.offdiag, with_dot=with_dot,
                                           out=y[r0:r1])
        self.halo.count(name, above, below)
        return out[1] if with_dot else None

    def _ell_band_spmv(self, p, hp, hn, with_dot):
        """The ELL kernel over the gather domain [halo_prev; band; halo_next]: global
        column c was rebased to c − (row_lo·g − g) when the operand was built."""
        dom = self.domain
        for row, src in ((dom[0:1], hp), (dom[-1:], hn)):
            if src is None:
                row.zero_()
            elif src.data_ptr() != row.data_ptr():
                row.copy_(src.reshape(row.shape))
        if p.data_ptr() != dom[1:-1].data_ptr():
            dom[1:-1].copy_(p)
        out = _ell.spmv_ell(self.ell_vals, self.ell_cols, dom, with_dot=with_dot,
                            dot_offset=self.grid_size)
        self.halo.count("spmv_ell", hp, hn)
        if with_dot:
            return out[0].reshape(self.field_shape), out[1]
        return out.reshape(self.field_shape)


def _sum_in_order(parts):
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total


def _real_rows(a, b, g):
    """The real rows [lo, hi) and the count of pad rows of padded rows [a, b) of a g-row
    grid (pad rows are the global rows >= g)."""
    lo, hi = min(a, g), min(b, g)
    return lo, hi, (b - a) - (hi - lo)


_OPERATOR_CACHE = {}


def clear_caches() -> None:
    """Drop the cached operators of synthesized operands (``make_sharded_operator`` with
    neither planes nor a matrix): each pins its planes or ELL band in device memory.
    Sweeps over grids call this between points, as ``tpusparse_torch.clear_caches()``
    does."""
    _OPERATOR_CACHE.clear()


def make_sharded_operator(grid_size: int, *, mode: str = "stencil5", planes=None,
                          matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                          dtype=torch.float32, overlap: bool = True,
                          device="cuda") -> ShardedOperator:
    """This rank's part of the sharded operator, its operand made for its rows only.

    ``stencil5``/``stencil5-bf16c``: the band's coefficient planes, synthesized on the
    device or sliced from ``planes`` (a whole (5, g, g) host array, a file's), in the
    state's dtype or bf16.  ``stencil5-const``: no operand; a grid that does not divide
    the ranks falls back to ``stencil5`` (zero planes keep the pad rows decoupled) with a
    line on stderr, and ``op.mode`` records what ran.  ``csr``: the band's rows of
    ``matrix`` (CSR, COO or Stencil5; None synthesizes the stencil) as an ELL operand
    over the gather domain; every nonzero's column must lie within one grid row of its
    row (the halo reach, the reference's partitioned kernels' contract), else
    ValueError.  Operators of synthesized operands are cached (``clear_caches``)."""
    g = int(grid_size)
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"sharded CG supports {'/'.join(MODES)}, got {mode}")
    nranks, rank = dist.world_size(), dist.rank()
    key = None
    if planes is None and matrix is None:
        key = (g, mode, diag, offdiag, dtype, overlap, device, rank, nranks)
        if key in _OPERATOR_CACHE:
            return _OPERATOR_CACHE[key]
    pad = (-g) % nranks
    band = (g + pad) // nranks
    row_lo = rank * band
    if pad and mode == "stencil5-const":
        if rank == 0:
            print(f"[tpusparse_torch] stencil5-const needs g % {nranks} == 0; grid {g} pads "
                  f"{pad} rows → falling back to values-carrying stencil5", file=sys.stderr)
        mode = "stencil5"
    common = dict(grid_size=g, mode=mode, diag=diag, offdiag=offdiag, dtype=dtype,
                  device=device, band=band, row_lo=row_lo, row_pad=pad)
    if mode == "csr":
        op = _make_ell_band(common, matrix)
    else:
        overlapped = overlap and nranks > 1 and band >= 3
        cuts = (0, 1, band - 1, band) if overlapped else (0, band)
        coeff = torch.bfloat16 if mode == "stencil5-bf16c" else dtype
        pieces = tuple((r0, r1, None if mode == "stencil5-const" else
                        _band_planes(g, row_lo + r0, row_lo + r1, planes, diag, offdiag,
                                     coeff, device))
                       for r0, r1 in zip(cuts[:-1], cuts[1:]))
        op = ShardedOperator(**common, overlap=overlap, pieces=pieces,
                             halo=_HaloExchange(g, dtype, device))
    if key is not None:
        _OPERATOR_CACHE[key] = op
    return op


def _band_planes(g, a, b, planes, diag, offdiag, coeff_dtype, device):
    """The coefficient planes of padded rows [a, b), (5, b − a, g)."""
    lo, hi, pad = _real_rows(a, b, g)
    if planes is None:
        return make_stencil5_planes_device(g, diag, offdiag, dtype=coeff_dtype, device=device,
                                           rows=(lo, hi), pad_rows=pad)
    src = torch.as_tensor(np.asarray(planes) if not torch.is_tensor(planes) else planes)
    if tuple(src.shape) != (5, g, g):
        raise ValueError(f"planes must be (5, {g}, {g}), got {tuple(src.shape)}")
    out = torch.zeros((5, b - a, g), dtype=coeff_dtype, device=device)
    out[:, :hi - lo] = src[:, lo:hi].to(device=device, dtype=coeff_dtype)
    return out


def _make_ell_band(common, matrix) -> ShardedOperator:
    """The ``csr`` band: this rank's rows as a slot-major ELL operand, columns rebased
    into the gather domain (the JAX package's ``_make_sharded_ell_operator`` and
    ``_ell_band_spmv``).  Pad rows: zero values, every column at the row itself."""
    g, dtype, device = common["grid_size"], common["dtype"], common["device"]
    band, row_lo = common["band"], common["row_lo"]
    lo, hi, pad = _real_rows(row_lo, row_lo + band, g)
    diag, offdiag = common["diag"], common["offdiag"]
    if matrix is None and stencil5_ell_device_ok(g, diag, offdiag):
        vals, cols = make_stencil5_ell_device(g, diag, offdiag, dtype=dtype, device=device,
                                              rows=(lo, hi), pad_rows=pad)
        nnz = stencil5_nnz(g)
    else:
        if matrix is None:
            matrix = make_stencil5(g, diag, offdiag, dtype=np.float32)
        csr = _as_csr(matrix)
        n = g * g
        if csr.num_rows != n or csr.num_cols != n:
            raise ValueError(
                f"sharded csr mode needs a g²×g² matrix for the (g, g) field; got "
                f"{csr.num_rows}x{csr.num_cols} with g={g}")
        col, val = _ell_rows(csr, lo * g, hi * g, g)
        if pad:  # pad rows: zero values, every column at the row itself
            prow = np.arange(hi * g, (hi + pad) * g, dtype=np.int64)[:, None]
            col = np.concatenate([col, np.broadcast_to(prow, (pad * g, col.shape[1]))])
            val = np.concatenate([val, np.zeros((pad * g, val.shape[1]), val.dtype)])
        from .. import convert

        vals, cols = convert.ell_from_numpy(col, val, dtype, device)
        nnz = csr.nnz
    cols.sub_(row_lo * g - g)  # global column -> index into the gather domain
    domain = torch.zeros((band + 2, g), dtype=dtype, device=device)
    halo = _HaloExchange(g, dtype, device, out_prev=domain[0:1], out_next=domain[-1:])
    return ShardedOperator(**common, overlap=False, halo=halo, ell_vals=vals, ell_cols=cols,
                           domain=domain, nnz_actual=nnz)


def _as_csr(mat) -> formats.CSRMatrix:
    if isinstance(mat, formats.CSRMatrix):
        return mat
    if isinstance(mat, formats.COOMatrix):
        return formats.coo_to_csr(mat)
    if isinstance(mat, formats.Stencil5):
        return formats.stencil5_to_csr(mat)
    raise TypeError(f"cannot interpret {type(mat)} as a matrix")


def _ell_rows(csr, r0, r1, g):
    """Rows [r0, r1) of a CSR as an (r1 − r0, W) ELL pack (``formats.csr_to_ell``), its
    columns global; ValueError if a nonzero lies beyond one grid row of its row.  A zero
    entry beyond it (an explicit zero) gets its row's own column: it adds nothing, and the
    gather domain holds it."""
    ptr = csr.row_ptr[r0:r1 + 1]
    s, e = int(ptr[0]), int(ptr[-1])
    sub = formats.CSRMatrix(num_rows=r1 - r0, num_cols=csr.num_cols, row_ptr=ptr - s,
                            col_idx=csr.col_idx[s:e], val=csr.val[s:e])
    ell = formats.csr_to_ell(sub)
    rows = np.arange(r0, r1, dtype=np.int64)[:, None]
    far = np.abs(ell.col - rows) > g
    if np.any(far & (ell.val != 0)):
        raise ValueError(
            "matrix has nonzeros beyond one grid-row of their row — the sharded generic "
            "kernel's halo reach (one grid-row per neighbor, reference parity) cannot "
            "cover it; use the single-chip csr operator")
    col = np.where(far, np.broadcast_to(rows, ell.col.shape), ell.col)
    return col, ell.val


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def cg_solve_sharded(grid_size: int, *, b=None, mode: str = "stencil5-const", planes=None,
                     matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                     tolerance: float = 1e-6, max_iters: int = 1000, dtype=torch.float32,
                     overlap: bool = True, config: Optional[CGConfig] = None,
                     use_pallas_blas1: Optional[bool] = None,
                     operator: Optional[ShardedOperator] = None,
                     recompute_ap: Optional[bool] = None, device="cuda"):
    """Sharded CG solve on this rank's band, every rank of the group calling it.  Returns
    (x, CGStats) with x this rank's band, (band, g) on its device, pad rows included;
    ``dist.gather_to_host(x, rows=g)`` gives rank 0 the field.  (The JAX package returned
    a sharded global array, or a host array when the grid was padded.)

    ``b``: None builds each rank's band of b = ones; else the whole (g, g) field, of which
    each rank takes its rows.  ``recompute_ap``: None runs the recompute loop (K1, K2)
    when the operator is ``stencil5-const``, as the JAX package does; True requires it.
    ``use_pallas_blas1``: True or None runs K4-K6, False plain PyTorch ops.  The
    convergence test and the ``CGStats`` fields are those of ``cg.cg_solve``:
    iterations while rr > tol²·<b, b>.  ``operator``: a prebuilt operator (the CLI's),
    else one is made (``make_sharded_operator``)."""
    if config is not None:
        tolerance, max_iters = config.tolerance, config.max_iters
    op = operator if operator is not None else make_sharded_operator(
        grid_size, mode=mode, planes=planes, matrix=matrix, diag=diag, offdiag=offdiag,
        dtype=dtype, overlap=overlap, device=device)
    recompute = op.mode == "stencil5-const" if recompute_ap is None else bool(recompute_ap)
    if recompute and op.mode != "stencil5-const":
        raise ValueError("recompute_ap: only mode='stencil5-const' provides the recompute "
                         "passes in the sharded solver")
    kernels = use_pallas_blas1 is not False
    dot = blas1.dot if kernels else blas1.dot_plain

    t0 = time.perf_counter()
    r = op.ones_b() if b is None else op.band_of(b)  # x0 = 0: r0 = b
    x = torch.zeros_like(r)
    rr = rr0 = _allsum(dot(r, r))
    tol2 = (tolerance * tolerance) * rr0
    k = 0
    if recompute:
        x, r, rr, k = _recompute_loop(op, x, r, rr, tol2, max_iters)
    else:
        cg_update = blas1.cg_update if kernels else blas1.cg_update_plain
        p_update = blas1.p_update if kernels else blas1.p_update_plain
        p = op.p_buffer()
        p.copy_(r)  # its own buffer: K4 updates r in place while it reads p
        while k < max_iters and bool(rr > tol2):
            with profiling.scope(profiling.PHASE_SPMV):
                ap, pap = op.local_spmv_dot(p)
            with profiling.scope(profiling.PHASE_AXPY):
                x, r, rr_local = cg_update(_on(rr / pap, op.device, op.dtype), x, r, p, ap)
            del ap
            rr_new = _allsum(rr_local)
            with profiling.scope(profiling.PHASE_UPDATE_P):
                p_update(_on(rr_new / rr, op.device, op.dtype), r, p)  # p = r + β·p
            rr = rr_new
            k += 1
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    total_ms = (time.perf_counter() - t0) * 1e3
    res, b_norm = float(rr) ** 0.5, float(rr0) ** 0.5
    stats = CGStats(
        iterations=k,
        converged=bool(res < tolerance * b_norm) if b_norm > 0 else True,
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )
    return x, stats


def _recompute_loop(op, x, r, rr, tol2, max_iters):
    """The recompute-Ap iteration, sharded: p′'s boundary rows r + β·p are formed on the
    device (two rows, plain PyTorch, rounded as K1 rounds p′: the product, then the sum)
    and exchanged once, then K1 forms p′ and <p′, A·p′> and K2 x′, r′ and <r′, r′>, both
    over the same halo rows.  The halo volume is the classic loop's: one row per
    neighbour per iteration."""
    p_prev = torch.zeros_like(r)
    p_buf = torch.empty_like(r)
    rr_prev = torch.ones_like(rr)
    kw = {"diag": op.diag, "offdiag": op.offdiag}
    k = 0
    while k < max_iters and bool(rr > tol2):
        beta = _on(0.0 if k == 0 else rr / rr_prev, op.device, op.dtype)
        if op.halo.prev is not None or op.halo.next is not None:
            ends = slice(0, None, max(op.band - 1, 1))  # rows 0 and band - 1, as a view
            rows = r[ends] + beta * p_prev[ends]
            op.halo.start(rows[0], rows[-1])
        hp, hn = op.halo.finish()
        with profiling.scope(profiling.PHASE_SPMV):
            p, pap_local = _st5.spmv_stencil5_const_pupdate_dot(beta, r, p_prev, hp, hn,
                                                                out=p_buf, **kw)
        op.halo.count("spmv_stencil5_const_pupdate_dot", hp, hn)
        pap = _allsum(pap_local)
        with profiling.scope(profiling.PHASE_AXPY):
            x, r, rr_local = _st5.cg_const_update_recompute(
                _on(rr / pap, op.device, op.dtype), x, r, p, hp, hn, **kw)
        op.halo.count("cg_const_update_recompute", hp, hn)
        rr_new = _allsum(rr_local)
        p_buf, p_prev = p_prev, p
        rr_prev, rr = rr, rr_new
        k += 1
    return x, r, rr, k


def cg_solve_sharded_stepped(grid_size: int, *, b=None, mode: str = "stencil5",
                             planes=None, matrix=None, diag: float = 5.0,
                             offdiag: float = -1.0, tolerance: float = 1e-6,
                             max_iters: int = 1000, dtype=torch.float32, overlap: bool = True,
                             verbose: int = 0, operator: Optional[ShardedOperator] = None,
                             device="cuda"):
    """Host-stepped sharded classic CG with wall time per phase: the multichip CLI's
    ``--timers`` loop, with the reference's CGStatsMultiGPU buckets
    (cg_solver_mgpu.h:55-67).  Every phase ends in ``torch.cuda.synchronize()`` on a card:

      halo_time_ms      — the boundary rows' D2H copy, their gloo exchange and the H2D
                          copy of the halos (the reference's staged MPI_Isend/Irecv);
      spmv_time_ms      — the band's SpMV with the halos provided: compute only;
      allreduce_time_ms — <r0, r0> and <p, A·p> through K6, and each dot's read to the
                          host, gloo all_gather and rank-ordered sum (<r, r> comes from
                          K4, so its local pass is in blas1); mirrored into
                          reduction_time_ms for the single-device field parity;
      blas1_time_ms     — K4 (x, r and the local <r, r>) and K5 (p).

    α and β are formed on the host in double precision.  The JAX package's dispatch
    correction, a relay correction, has no counterpart.  Returns (x band, CGStats), as
    ``cg_solve_sharded``."""
    op = operator if operator is not None else make_sharded_operator(
        grid_size, mode=mode, planes=planes, matrix=matrix, diag=diag, offdiag=offdiag,
        dtype=dtype, overlap=overlap, device=device)
    def sync():
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)

    stats = CGStats()
    t_solve = time.perf_counter()
    r = op.ones_b() if b is None else op.band_of(b)
    x = torch.zeros_like(r)
    p = op.p_buffer()
    p.copy_(r)
    t0 = time.perf_counter()
    rr = float(_allsum(blas1.dot(r, r)))
    stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
    b_norm = rr ** 0.5
    k = 0
    converged = rr == 0.0  # a zero right-hand side: x = 0, no iteration
    while k < max_iters and not converged:
        t0 = time.perf_counter()
        hp, hn = op.halo.exchange(p)
        sync()
        t1 = time.perf_counter()
        with profiling.scope(profiling.PHASE_SPMV):
            ap = op.local_spmv(p, hp, hn)
            sync()
        t2 = time.perf_counter()
        pap = float(_allsum(blas1.dot(p, ap)))
        t3 = time.perf_counter()
        with profiling.scope(profiling.PHASE_AXPY):
            x, r, rr_local = blas1.cg_update(rr / pap, x, r, p, ap)
            sync()
        t4 = time.perf_counter()
        rr_new = float(_allsum(rr_local))
        t5 = time.perf_counter()
        del ap
        stats.halo_time_ms += (t1 - t0) * 1e3
        stats.spmv_time_ms += (t2 - t1) * 1e3
        stats.allreduce_time_ms += ((t3 - t2) + (t5 - t4)) * 1e3
        stats.blas1_time_ms += (t4 - t3) * 1e3
        k += 1
        if verbose >= 2 and dist.rank() == 0:
            print(f"[CG-SHARDED] Iter {k:3d}: rel = {rr_new ** 0.5 / b_norm:e}")
        if rr_new ** 0.5 < tolerance * b_norm:
            converged = True
        else:
            t0 = time.perf_counter()
            with profiling.scope(profiling.PHASE_UPDATE_P):
                blas1.p_update(rr_new / rr, r, p)
                sync()
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        rr = rr_new
    stats.reduction_time_ms = stats.allreduce_time_ms
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm else 0.0
    return x, stats

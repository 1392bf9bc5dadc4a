"""Sharded Conjugate Gradient of the port: ``tpusparse/solvers/cg_sharded.py``, its row
bands (reference ``cg_solve_mgpu_partitioned``, src/solvers/cg_solver_mgpu_partitioned.cu:
236-908) and its 2-D blocks, over one of two transports.

  reference (CUDA + MPI)          JAX package                  this port
  ------------------------------  ---------------------------  ----------------------------
  1 MPI rank = 1 GPU              1 process drives a Mesh      mesh: 1 process drives a
                                  (multi-host: 1 a host)       ``dist.Mesh`` (or its share
                                                               of one across ranks); gloo:
                                                               1 rank = 1 process on 1
                                                               device
  row bands n/P (+ remainder)     rows sharded P("x"), zero    the same bands, (−g mod P)
                                  pad rows                     zero pad rows at the end
  pinned-host staged halo         ``ppermute`` of one row      mesh: device copies into
    (D2H -> MPI -> H2D)             per neighbour                the halo buffers; gloo:
                                                                 D2H, isend/irecv, H2D
  cublasDdot + MPI_Allreduce      local dot + ``psum``         partials summed in shard
                                                               order: mesh on its first
                                                               device, gloo on each host
  MPI_Gatherv of x                out_spec resharding          mesh: ``assemble``; gloo:
                                                               ``dist.gather_to_host``

**The mesh** (``MeshOperator``, ``mesh=`` of the solvers), the JAX package's single
controller: one process holds a ``ShardedOperator`` a shard, each on its device of the
mesh.  A halo exchange copies each shard's neighbours' boundary rows (and on a 2-D mesh
columns, strided, in one copy each) straight from their fields into its halo buffers,
allocated once; a copy between cards is a peer copy, which ``Tensor.copy_`` orders with
CUDA events between the two devices' streams; a shard at the grid's edge has no buffer
there (zero, as ``ppermute`` zero-filled).  A dot's per-shard partials are copied to the
mesh's first device and added there in shard order, in their dtype (``_mesh_sum``): the
gloo ranks' order, so both transports give the same bits, and the iteration counts stay
equal across decompositions.  α and β stay on the device.  With every shard on one card
the loop runs from a captured CUDA graph (``MeshLoop``, on ``cg.DeviceLoop``'s WHILE and
IF nodes): one replay and one read a solve, the JAX package's one ``lax.while_loop`` with
no host round-trip.  Across cards (or on one card with ``per_shard=True``) each card runs
that loop over its shards from a graph of its own (``CardLoop``), as every JAX device
runs the ``shard_map``-wrapped loop: halo rows and dot partials are stored by kernels
straight into the other shards' buffers, each shard waits for them and adds the partials
in shard order itself (``kernels/mesh_sync.py``), so every card holds the same sums and
runs the same iterations; a card's shards meet each sync point in lockstep, so only the
waits for other cards spin; one replay a card and one read a solve.  With
``graph=False`` the iteration runs eagerly, the flag k < max_iters and rr > tol² read
once an iteration.  A mesh across the ranks of a group (``dist.make_rank_mesh``, bands
or blocks, the JAX package's multi-host mode: each rank drives its share of the shards)
passes halos between a rank's own shards by device copies, the rows and columns whose
neighbour lives on another rank and every dot's partials by the group's transport
(``_RankLink``: NCCL card to card, or gloo through the host), the partials added in
global shard order, so x is the one-process mesh's bit for bit.  Over NCCL, with the
rank's shards on one card of its own, each rank runs the loop from one CUDA graph
(``MeshLoop``: its WHILE node, each iteration under an IF node, the rank's kernels and
NCCL's exchanges and all-gathers captured inside them), as each JAX process runs one
compiled ``while_loop`` with its ``ppermute`` and ``psum`` inside: one replay and one
read a rank a solve; every rank sums the same partials in the same order, so every
rank's condition sees the same rr and every rank makes the same calls.  With the rank's
shards on several cards of its own, each card runs the loop from a graph of its own
(``RankCardLoop``: ``CardLoop``'s graphs, the rank's cards meeting through each other's
memory, NCCL's calls in the home card's graph only): one replay a card and one read a
rank a solve.  A peer that never comes to a captured call would hang the replay, and
NCCL's watchdog does not watch captured work: the host watches the replay's k, and where
no iteration ends for ``RANK_WAIT_BOUND_S`` it aborts the group's communicator and
raises.  Over gloo the loop runs eagerly, its flag read once an iteration.

**The ranks** (every other entry, each rank calling the solver), the counterpart of the
JAX package's multi-host mode, over one of two transports (``dist.device_group``).  Where
every rank has a card of its own, NCCL moves the halo rows and columns card to card
(``batch_isend_irecv``) and all-gathers each dot's partials on the card, where every rank
adds them in rank order (``sum_in_shard_order``), and the loop runs from one CUDA graph a
rank (``rank_mesh``: the rank's band or block as a mesh across the ranks of one shard a
rank, ``MeshLoop``'s graph as above; a mesh across ranks whose rank drives several cards:
one graph a card, ``RankCardLoop``); with ``graph=False`` eagerly, α and β on the card
and the flag read once an iteration.  Elsewhere (ranks on the CPU, ranks sharing a card,
where NCCL refuses to run) gloo moves CPU tensors only, so the halos and the dots pass
through the host, as the reference's did: each rank's partial goes to its host, gloo
gathers the N partials, every rank adds them in rank order (the same function), and α and
β go back to the device as 0-d tensors: two more reads an iteration.

A bf16 state (``dtype=torch.bfloat16``) runs the classic and stepped loops on bands and
blocks: halo rows and columns in bf16, each shard's partial dot f32, α and β rounded to
bf16 on the device; the recompute loop refuses it, as the JAX package's does
(``cg.check_loop``).

Kernels, all with the halo rows as pointers (``kernels.stencil5``, ``kernels.ell``):

  - ``stencil5``, ``stencil5-bf16c``: K8 over the band's coefficient planes;
  - ``stencil5-const``: K3, or in the recompute loop (its default) K1 and K2;
  - ``csr``: the ELL kernel (K12/K13's), rectangular, over a gather domain of the band
    with a halo row on either side, (band + 2)·g entries whose middle rows are p itself;
  - the classic loop's K4 and K5, and K6 for <r0, r0>, the stepped loop's dots and a 2-D
    block's side-column terms.

``HALO_CALLS`` counts the exchanges and, by wrapper, the calls whose halo row is one that
an exchange received (not a row of the band itself, not an edge's zero row), summed over
a mesh's shards.

The overlapped SpMV (``overlap=True`` with more than one shard and bands of 3 rows or
more, the JAX package's ``_spmv_dot_overlapped``): the interior rows' kernel runs first
(their halos are the band's own rows), then the boundary rows' kernels with the exchanged
halo rows; a gloo rank queues its boundary rows' D2H copy before the interior kernel and
exchanges them while the card runs it.  The planes of a band are kept as three contiguous
pieces (first row, interior, last row) so that each kernel reads its own rows' planes; y
of each piece goes straight into its rows of one y.  Every row is computed by the same
kernel arithmetic either way, so the overlapped y equals the synchronous y bit for bit;
only the dot's sum is grouped differently.

The 2-D block decomposition (``cg_solve_sharded_2d``, the JAX package's, beyond the
reference): on an R×C mesh, shard k = i·C + j holds block (i, j), grid rows
[i·g/R, (i+1)·g/R) and columns [j·g/C, (j+1)·g/C), as its own contiguous (g/R, g/C)
field; the grid must divide by R and C.  Its N/S neighbours are shards k ∓ C, its W/E
neighbours k ∓ 1; one exchange swaps rows (g/C long) and columns (g/R long) with all of
them.  K8 or K3 runs on the block with the exchanged rows as halo rows, as on a band;
they see no column beyond the block (its W/E terms there are 0), so the neighbours'
columns come in as two corrections, y[:, 0] += W[:, 0]·h_w and y[:, -1] += E[:, -1]·h_e
(plain PyTorch, as the JAX package formed them in XLA).  The JAX package's Pallas kernel
duplicated the edge column instead and its correction replaced that term
(``W·(h_w − x[:, 0])``, ``cg_sharded.py:1013-1019``); here the term was 0, so the
correction adds, as the JAX constant stencil's did.  Their terms of <p, A·p> are
<p[:, 0], W[:, 0]·h_w> and <p[:, -1], E[:, -1]·h_e>, each through K6 on a contiguous copy
of p's column.  The classic loop (K4, K5) and the stepped loop run on blocks as on bands;
the recompute loop and ``csr`` are bands only, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist, formats
from .._device import resolve_device, resolve_dtype
from ..bench import profiling
from ..generate import (make_stencil5, make_stencil5_ell_device, make_stencil5_planes_device,
                        ones_band, stencil5_ell_device_ok, stencil5_nnz)
from ..kernels import _launch, blas1, mesh_sync
from ..kernels import ell as _ell
from ..kernels import graph as graph_kernels
from ..kernels import stencil5 as _st5
from . import cg
from .cg import CGConfig, CGStats, check_loop

MODES = ("stencil5", "stencil5-bf16c", "stencil5-const", "csr")

# the exchanges that received a neighbour's row ("exchange"), and by wrapper the calls given
# a row that an exchange received (on a card each call is one launch of its kernel): they
# show that the halo rows a kernel read came from a neighbour, not from the band or an edge;
# on a 2-D mesh also the exchanges that received a neighbour's column ("column_exchange")
# and the side-column corrections given a column that an exchange received
# ("column_correction"); a mesh's shards all count here
HALO_CALLS = dict.fromkeys(("exchange", "spmv_stencil5", "spmv_stencil5_const",
                            "spmv_stencil5_const_pupdate_dot", "cg_const_update_recompute",
                            "spmv_ell", "column_exchange", "column_correction"), 0)


def reset_halo_calls() -> None:
    for name in HALO_CALLS:
        HALO_CALLS[name] = 0


class _Halo:
    """The halo of shard ``index`` of a row-major (R, C) ``mesh_shape``: its neighbours
    (the N/S ones ``index`` ∓ C, the W/E ones ``index`` ∓ 1 in its mesh row; a row band is
    the (N, 1) mesh; None at the grid's edge) and the device buffers their rows (1, g) and
    columns (rows,) arrive in, allocated here, once (``out_prev``/``out_next``: the rows'
    buffers given).  A missing neighbour has no buffer: zero, the Dirichlet boundary as
    data, as ``ppermute`` zero-filled.  No corner is exchanged: the 5-point stencil has no
    diagonal neighbour.  A mesh fills the buffers with device copies
    (``MeshOperator.exchange``); ``_HaloExchange``, a gloo rank's, through the host."""

    def __init__(self, index, mesh_shape, g, rows, dtype, device, out_prev=None,
                 out_next=None):
        nr, nc = mesh_shape
        i, j = divmod(index, nc)
        self.prev = index - nc if i > 0 else None
        self.next = index + nc if i < nr - 1 else None
        self.west = index - 1 if j > 0 else None
        self.east = index + 1 if j < nc - 1 else None
        self.has_rows = self.prev is not None or self.next is not None
        self.has_cols = self.west is not None or self.east is not None

        def buf(out, shape):
            return out if out is not None else torch.zeros(shape, dtype=dtype, device=device)

        self.halo_prev = buf(out_prev, (1, g)) if self.prev is not None else None
        self.halo_next = buf(out_next, (1, g)) if self.next is not None else None
        self.halo_w = buf(None, (rows,)) if self.west is not None else None
        self.halo_e = buf(None, (rows,)) if self.east is not None else None

    def halos(self):
        """(halo_prev, halo_next, halo_w, halo_e): rows (1, g) and columns (rows,), each
        None at the grid's edge."""
        return self.halo_prev, self.halo_next, self.halo_w, self.halo_e

    def count(self, name, *rows) -> None:
        """Count a call of wrapper ``name`` if one of ``rows`` is a row this halo
        received."""
        got = [h for h in (self.halo_prev, self.halo_next) if h is not None]
        if any(row is h for row in rows for h in got):
            HALO_CALLS[name] += 1

    def count_column(self, col) -> None:
        """Count a side-column correction if ``col`` is a column this halo received."""
        if any(col is h for h in (self.halo_w, self.halo_e) if h is not None):
            HALO_CALLS["column_correction"] += 1


class _HaloExchange(_Halo):
    """One rank's exchange of boundary rows, and on a 2-D mesh of boundary columns, with
    its neighbours (the JAX package's ``_band_halo_exchange`` and ``_halo_exchange_2d``),
    the rank this process's, its neighbours ranks of the group (``_Halo``; ``mesh_shape``
    None: the group's ranks as row bands).  ``start`` sends what its neighbours need and
    ``finish`` gives the halos once what they sent has arrived, over one of two
    transports (``dist.device_group``; ``transport`` "gloo" asks for the second):

      - ``nccl``, where every rank has a card of its own: one ``batch_isend_irecv`` of the
        device tensors on the group's NCCL stream, the rows straight from the field into
        the neighbours' halo buffers; ``finish`` only orders the current stream after it;
      - ``gloo``, staged through pinned host buffers as the reference staged it: ``start``
        queues the D2H copy, ``finish`` waits for it, swaps by gloo and copies to the
        device.

    Every buffer is allocated here, once: a field's side columns are strided, so they are
    first gathered into a contiguous device buffer."""

    def __init__(self, g, dtype, device, out_prev=None, out_next=None, mesh_shape=None,
                 rows=0, transport=None):
        super().__init__(dist.rank(), mesh_shape or (dist.world_size(), 1), g, rows, dtype,
                         device, out_prev, out_next)
        self.device = device
        self.group = dist.device_group(device, transport)
        self.transport = "gloo" if self.group is None else "nccl"
        cuda = device.type == "cuda"
        self.event = torch.cuda.Event() if cuda and self.group is None else None
        self.works = []

        def staging(n):
            return torch.empty((2, n), dtype=dtype, pin_memory=cuda)

        if self.has_rows and self.group is None:
            self.send, self.recv = staging(g), staging(g)
        if self.has_cols:
            self.cols = torch.empty((2, rows), dtype=dtype, device=device)
            if self.group is None:
                self.send_cols, self.recv_cols = staging(rows), staging(rows)

    def start(self, first, last, field=None):
        """Send the rows ``first`` (to the previous rank) and ``last`` (to the next) and,
        on a 2-D mesh, ``field``'s first column (to the west rank) and last column (to the
        east): over NCCL the exchange itself, over gloo the D2H copy of what it sends."""
        if not (self.has_rows or self.has_cols):
            return
        with profiling.scope(profiling.PHASE_HALO):
            if self.has_cols:
                self.cols[0].copy_(field[:, 0])
                self.cols[1].copy_(field[:, -1])
            if self.group is not None:
                sides = [(self.prev, first, self.halo_prev), (self.next, last, self.halo_next)]
                if self.has_cols:
                    sides += [(self.west, self.cols[0], self.halo_w),
                              (self.east, self.cols[1], self.halo_e)]
                ops = [op for peer, send, out in sides if peer is not None
                       for op in (tdist.P2POp(tdist.isend, send.reshape(-1), peer, self.group),
                                  tdist.P2POp(tdist.irecv, out.reshape(-1), peer, self.group))]
                with _current(self.device):
                    self.works = tdist.batch_isend_irecv(ops)
                return
            if self.has_rows:
                self.send[0].copy_(first.reshape(-1), non_blocking=True)
                self.send[1].copy_(last.reshape(-1), non_blocking=True)
            if self.has_cols:
                self.send_cols.copy_(self.cols, non_blocking=True)
            if self.event is not None:
                self.event.record()

    def finish(self):
        """The halos on the device (``_Halo.halos``), once the exchange is through."""
        if not (self.has_rows or self.has_cols):
            return self.halos()
        with profiling.scope(profiling.PHASE_HALO):
            if self.group is not None:
                with _current(self.device):
                    for work in self.works:  # the current stream waits for NCCL's
                        work.wait()
                self.works = []
            else:
                if self.event is not None:
                    self.event.synchronize()
                links = []
                if self.has_rows:
                    links += [(self.prev, self.send[0], self.recv[0], self.halo_prev),
                              (self.next, self.send[1], self.recv[1], self.halo_next)]
                if self.has_cols:
                    links += [(self.west, self.send_cols[0], self.recv_cols[0], self.halo_w),
                              (self.east, self.send_cols[1], self.recv_cols[1], self.halo_e)]
                links = [link for link in links if link[0] is not None]
                ops = [op for peer, send, recv, _ in links
                       for op in (tdist.P2POp(tdist.isend, send, peer),
                                  tdist.P2POp(tdist.irecv, recv, peer))]
                for req in tdist.batch_isend_irecv(ops):
                    req.wait()
                for _, _, recv, out in links:
                    out.copy_(recv.reshape(out.shape), non_blocking=True)
            HALO_CALLS["exchange"] += self.has_rows
            HALO_CALLS["column_exchange"] += self.has_cols
        return self.halos()

    def exchange(self, field):
        """The halos of a (rows, g) field: its first row goes to the previous rank, its
        last to the next, and on a 2-D mesh its first column to the west rank, its last
        to the east."""
        self.start(field[0], field[-1], field)
        return self.finish()


def sum_in_shard_order(flat, out=None):
    """flat[0] + flat[1] + ... of a 1-D tensor, added left to right in its dtype on its
    device, as a 0-d tensor (into ``out`` when given: nothing is allocated): the one sum
    of the ranks' partials, on the host (gloo) or on the card (NCCL), so both give the
    same bits (and ``_mesh_sum``'s)."""
    total = flat[0].clone() if out is None else out.copy_(flat[0])
    for t in flat[1:]:
        total += t
    return total


def _allsum(*parts, group=None):
    """The sum over the ranks of each rank's partials (0-d tensors, in shard order: one a
    rank, or a mesh across ranks' rank's share) as a 0-d tensor in their dtype, every
    rank the same bits: every rank's gathered and all of them added left to right in
    global shard order (``sum_in_shard_order``; ``_mesh_sum``'s order), never an
    all-reduce, whose order the library picks.  ``group`` (``dist.device_group``) None:
    each rank's partials go to its host in one copy and gloo gathers them, the sum a CPU
    tensor; an NCCL group: copied into one buffer on the first part's card and
    all-gathered there (``all_gather_into_tensor``), the sum on that card, no host step.
    The NCCL form allocates nothing under a ``_launch.Workspace`` (its three buffers are
    ``_launch.buffer``'s), so a rank's captured loop holds it: it records one buffer set
    a call site, as the kernels' dots do."""
    with profiling.annotate(profiling.PHASE_DOT):
        n = dist.world_size()
        if group is not None:
            dev, dtype = parts[0].device, parts[0].dtype
            local = _launch.buffer((len(parts),), dtype, dev)
            for slot, t in zip(local, parts):
                slot.copy_(t.detach().reshape(()))
            every = _launch.buffer((n * len(parts),), dtype, dev)
            with _current(dev):
                tdist.all_gather_into_tensor(every, local, group=group)
            return sum_in_shard_order(every, out=_launch.buffer((), dtype, dev))
        local = torch.stack([t.detach().reshape(()).to(parts[0].device) for t in parts])
        host = local.to("cpu")
        every = [host] if n == 1 else [torch.empty_like(host) for _ in range(n)]
        if n > 1:
            tdist.all_gather(every, host)
        return sum_in_shard_order(torch.cat(every))


def _on(t, device, dtype):
    """A scalar (a float, or a 0-d tensor) as a 0-d tensor on the device in ``dtype``: a
    host value by a fill, a value already there by a cast on the device; neither makes
    the host wait."""
    if torch.is_tensor(t) and t.device == device:
        return t.to(dtype)
    return torch.full((), float(t), dtype=dtype, device=device)


@dataclasses.dataclass(eq=False)
class ShardedOperator:
    """One shard of the sharded operator, a gloo rank's or a mesh's: the sharded
    counterpart of ``ops.DeviceOperator`` and of the JAX package's ``ShardedOperator``.

    Every shard holds ``band`` rows, global rows [row_lo, row_lo + band) of the grid padded
    with ``row_pad`` zero rows to a multiple of the shards, and ``cols`` columns from
    ``col_lo``: all g of them on a row band, its block's on a 2-D ``mesh_shape`` (R, C).
    ``pieces`` cover the rows, ((r0, r1, planes of rows [r0, r1) or None), ...): one
    piece, or three when the SpMV overlaps its halo exchange.  ``halo``: the shard's
    ``_Halo`` (a gloo rank's ``_HaloExchange``).  ``side_coeffs``: on a 2-D mesh, the
    coefficients of the west and east neighbours' columns, W[:, 0] and E[:, -1] of the
    block's planes in the state's dtype, or the constant stencil's offdiag, and
    ``side_buf``, (2, 2, band): for each side, the buffer its terms are written into each
    iteration and a contiguous copy of p's column there.  ``csr``: ``ell_vals``/``ell_cols``
    (W, band·g), the columns rebased into ``domain``, the (band + 2, g) gather domain whose
    middle rows are the p the solver updates (``p_buffer``)."""

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
    halo: _Halo
    cols: int
    col_lo: int = 0
    mesh_shape: Optional[tuple] = None
    side_coeffs: tuple = (None, None)
    side_buf: Optional[torch.Tensor] = None
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
        return (self.band, self.cols)

    def ones_b(self, out=None):
        """This shard's part of b = ones, into ``out`` when given: zero on the pad rows
        (they are decoupled)."""
        g = self.grid_size
        lo, hi, pad = _real_rows(self.row_lo, self.row_lo + self.band, g)
        return ones_band(g, (lo, hi), pad, dtype=self.dtype, device=self.device,
                         cols=(self.col_lo, self.col_lo + self.cols), out=out)

    def band_of(self, field):
        """This shard's rows (its block's rows and columns on a 2-D mesh) of a whole
        (g, g) field (numpy or tensor), pad rows zero."""
        g = self.grid_size
        lo, hi, pad = _real_rows(self.row_lo, self.row_lo + self.band, g)
        t = torch.as_tensor(np.asarray(field) if not torch.is_tensor(field) else field)
        if tuple(t.shape) != (g, g):
            raise ValueError(f"b must be a ({g}, {g}) field, got {tuple(t.shape)}")
        out = torch.zeros(self.field_shape, dtype=self.dtype, device=self.device)
        out[:hi - lo] = t[lo:hi, self.col_lo:self.col_lo + self.cols].to(
            device=self.device, dtype=self.dtype)
        return out

    def p_buffer(self):
        """A field for the classic loop's p: for ``csr`` the middle rows of the gather
        domain, so that its halo rows arrive around it and no copy is made."""
        if self.domain is not None:
            return self.domain[1:-1]
        return torch.empty(self.field_shape, dtype=self.dtype, device=self.device)

    def local_spmv(self, p, hp=None, hn=None, hw=None, he=None, out=None):
        """This shard's y = A·p with the halo rows (and on a 2-D mesh the halo columns)
        provided (None = zero): compute only, no exchange; into ``out`` when given."""
        if self.mode == "csr":
            return self._ell_band_spmv(p, hp, hn, out=out)
        y = torch.empty_like(p) if out is None else out
        for piece in self.pieces:
            self._rows(p, piece, hp, hn, y, False)
        self._add_columns(p, y, hw, he, False)
        return y

    def spmv_dot(self, p, y, halos):
        """y = A·p into y, and this shard's <p, A·p> as a 0-d tensor.  When the SpMV
        overlaps its exchange, the interior piece runs first (its halo rows are p's own
        rows); then ``halos()`` gives (hp, hn, hw, he), which is where a gloo rank's
        exchange finishes while the card runs the interior; then the boundary pieces and
        the side columns.  The dots are summed in that order (``_sum_in_order``).  Nothing
        is allocated but the wrappers' dot buffers (a workspace's in a capture)."""
        if self.mode == "csr":
            hp, hn, _, _ = halos()
            return self._ell_band_spmv(p, hp, hn, True, out=y)[1]
        if self.overlapped:
            top, core, bottom = self.pieces
            dots = [self._rows(p, core, None, None, y, True)]
            hp, hn, hw, he = halos()
            dots += [self._rows(p, top, hp, hn, y, True), self._rows(p, bottom, hp, hn, y, True)]
        else:
            hp, hn, hw, he = halos()
            dots = [self._rows(p, piece, hp, hn, y, True) for piece in self.pieces]
        return _sum_in_order(dots + self._add_columns(p, y, hw, he, True))

    def local_spmv_dot(self, p):
        """A rank's y = A·p with its halo exchange, and the global <p, A·p> as a 0-d
        tensor (every rank the same bits; ``_allsum``)."""
        self.halo.start(p[0], p[-1], p)
        y = torch.empty_like(p)
        return y, _allsum(self.spmv_dot(p, y, self.halo.finish), group=self.halo.group)

    def edge_rows(self, r, p_prev, beta, out=None):
        """The recompute loop's p′ rows that its neighbours need: r + β·p_prev on rows 0
        and band − 1 (one row when the band has one), rounded as K1 rounds p′: the
        product, then the sum; into ``out`` (rows, g) when given."""
        ends = slice(0, None, max(self.band - 1, 1))  # rows 0 and band - 1, as a view
        if out is None:
            return r[ends] + beta * p_prev[ends]
        torch.mul(p_prev[ends], beta, out=out)
        return out.add_(r[ends])

    def _add_columns(self, p, y, hw, he, with_dot):
        """The block's side columns on a 2-D mesh: y[:, 0] += W[:, 0]·hw and y[:, -1] +=
        E[:, -1]·he, the west and east neighbours' terms, which the kernels (seeing no
        column beyond the block) took as 0 (the JAX package's ``_col_deltas``,
        ``cg_sharded.py:1013-1019``, whose kernel duplicated the edge column, so that its
        correction replaced a term; here it adds one).  With ``with_dot``, their terms of
        <p, y> through K6 on a contiguous copy of p's column (f32 for a bf16 state).  A
        None column (no neighbour there, a row band) adds nothing.  A bf16 state rounds the
        product and then the sum to bf16, the order of JAX's ``y.at[:, :1].add(dw)``."""
        dots = []
        for k, (col, h) in enumerate(((0, hw), (-1, he))):
            if h is None:
                continue
            d = torch.mul(h, self.side_coeffs[k], out=self.side_buf[k, 0])
            y[:, col].add_(d)
            self.halo.count_column(h)
            if with_dot:
                dots.append(blas1.dot(self.side_buf[k, 1].copy_(p[:, col]), d))
        return dots

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

    def _ell_band_spmv(self, p, hp, hn, with_dot=False, out=None):
        """The ELL kernel over the gather domain [halo_prev; band; halo_next]: global
        column c was rebased to c − (row_lo·g − g) when the operand was built.  y goes into
        ``out`` (a field) when given."""
        dom = self.domain
        for row, src in ((dom[0:1], hp), (dom[-1:], hn)):
            if src is None:
                row.zero_()
            elif src.data_ptr() != row.data_ptr():
                row.copy_(src.reshape(row.shape))
        if p.data_ptr() != dom[1:-1].data_ptr():
            dom[1:-1].copy_(p)
        res = _ell.spmv_ell(self.ell_vals, self.ell_cols, dom, with_dot=with_dot,
                            dot_offset=self.grid_size,
                            out=None if out is None else out.view(-1))
        self.halo.count("spmv_ell", hp, hn)
        if with_dot:
            return res[0].reshape(self.field_shape), res[1]
        return res.reshape(self.field_shape)


def _sum_in_order(parts):
    """parts[0] + parts[1] + ..., added left to right (0-d tensors of one device and
    dtype), into a ``_launch.buffer``: nothing is allocated in a capture."""
    if len(parts) == 1:
        return parts[0]
    total = _launch.buffer((), parts[0].dtype, parts[0].device)
    torch.add(parts[0], parts[1], out=total)
    for t in parts[2:]:
        total.add_(t)
    return total


def _real_rows(a, b, g):
    """The real rows [lo, hi) and the count of pad rows of padded rows [a, b) of a g-row
    grid (pad rows are the global rows >= g)."""
    lo, hi = min(a, g), min(b, g)
    return lo, hi, (b - a) - (hi - lo)


_OPERATOR_CACHE = {}


def clear_caches() -> None:
    """Drop the cached operators of synthesized operands (``make_sharded_operator`` and
    ``make_mesh_operator`` with neither planes nor a matrix), row bands' and 2-D blocks'
    alike, and the mesh operators' captured loops: each pins its planes or ELL band, and a
    loop its fields and graphs, in device memory.  Sweeps over grids call this between
    points, as ``tpusparse_torch.clear_caches()`` does."""
    for op in _OPERATOR_CACHE.values():
        if isinstance(op, MeshOperator):
            op.free()
    _OPERATOR_CACHE.clear()


def make_sharded_operator(grid_size: int, *, mode: str = "stencil5", planes=None,
                          matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                          dtype=torch.float32, overlap: bool = True,
                          device="cuda", mesh_shape=None, shard=None,
                          transport: Optional[str] = None) -> ShardedOperator:
    """One shard of the sharded operator, its operand made for its rows only, or with
    ``mesh_shape=(R, C)`` for its block of the 2-D decomposition (the JAX package's
    ``_shard_2d_planes``, ``cg_sharded.py:813-825``; ``_check_2d_mesh`` says what that
    takes): the block's planes cut from the global pattern, in three row pieces when the
    SpMV overlaps its exchange, as on a band.

    ``shard``: None, this rank of the group (``dist.rank()`` of ``dist.world_size()``), its
    halos exchanged by a ``_HaloExchange`` over ``transport`` (``dist.device_group``'s:
    NCCL where every rank has a card of its own, else gloo; every rank calling it);
    ``(index, count)``, shard ``index`` of ``count`` on ``device``, whose halo buffers a
    mesh fills (``make_mesh_operator``).

    ``stencil5``/``stencil5-bf16c``: the band's coefficient planes, synthesized on the
    device or sliced from ``planes`` (a whole (5, g, g) host array, a file's), in the
    state's dtype or bf16.  ``stencil5-const``: no operand; a grid that does not divide
    the shards falls back to ``stencil5`` (zero planes keep the pad rows decoupled) with a
    line on stderr, and ``op.mode`` records what ran.  ``csr``: the band's rows of
    ``matrix`` (CSR, COO or Stencil5; None synthesizes the stencil) as an ELL operand
    over the gather domain; every nonzero's column must lie within one grid row of its
    row (the halo reach, the reference's partitioned kernels' contract), else
    ValueError.  Operators of synthesized operands are cached (``clear_caches``).  Made
    inside an ``Operator_Build`` span (``bench.profiling``)."""
    with profiling.scope(profiling.PHASE_OPERATOR_BUILD):
        return _make_sharded_operator(grid_size, mode, planes, matrix, diag, offdiag, dtype,
                                      overlap, device, mesh_shape, shard, transport)


def _make_sharded_operator(grid_size, mode, planes, matrix, diag, offdiag, dtype, overlap,
                           device, mesh_shape, shard, transport):
    g = int(grid_size)
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"sharded CG supports {'/'.join(MODES)}, got {mode}")
    index, count = (dist.rank(), dist.world_size()) if shard is None else shard
    if mesh_shape is not None:
        mesh_shape = _check_2d_mesh(mesh_shape, g, mode, count)
    key = None
    if planes is None and matrix is None:
        key = (g, mode, diag, offdiag, dtype, overlap, device, index, count, mesh_shape,
               shard is None, transport)
        if key in _OPERATOR_CACHE:
            return _OPERATOR_CACHE[key]
    if mesh_shape is not None:
        (row_lo, row_hi), (col_lo, col_hi) = dist.block_of(index, mesh_shape, g)
        band, pad = row_hi - row_lo, 0
    else:
        pad = (-g) % count
        band = (g + pad) // count
        row_lo, col_lo, col_hi = index * band, 0, g
    if pad and mode == "stencil5-const":
        if index == 0:
            print(f"[tpusparse_torch] stencil5-const needs g % {count} == 0; grid {g} pads "
                  f"{pad} rows → falling back to values-carrying stencil5", file=sys.stderr)
        mode = "stencil5"

    def halo(cols, out_prev=None, out_next=None):
        if shard is None:
            return _HaloExchange(cols, dtype, device, out_prev, out_next,
                                 mesh_shape=mesh_shape, rows=band, transport=transport)
        return _Halo(index, mesh_shape or (count, 1), cols, band, dtype, device, out_prev,
                     out_next)

    common = dict(grid_size=g, mode=mode, diag=diag, offdiag=offdiag, dtype=dtype,
                  device=device, band=band, row_lo=row_lo, row_pad=pad, cols=col_hi - col_lo,
                  col_lo=col_lo, mesh_shape=mesh_shape)
    if mode == "csr":
        op = _make_ell_band(common, matrix, halo)
    else:
        overlapped = overlap and count > 1 and band >= 3
        cuts = (0, 1, band - 1, band) if overlapped else (0, band)
        coeff = torch.bfloat16 if mode == "stencil5-bf16c" else dtype
        pieces = tuple((r0, r1, None if mode == "stencil5-const" else
                        _band_planes(g, row_lo + r0, row_lo + r1, planes, diag, offdiag,
                                     coeff, device, cols=(col_lo, col_hi)))
                       for r0, r1 in zip(cuts[:-1], cuts[1:]))
        op = ShardedOperator(**common, overlap=overlap, pieces=pieces,
                             side_coeffs=(None, None) if mesh_shape is None
                             else _side_coeffs(mode, pieces, offdiag, dtype),
                             side_buf=None if mesh_shape is None
                             else torch.empty((2, 2, band), dtype=dtype, device=device),
                             halo=halo(col_hi - col_lo))
    if key is not None:
        _OPERATOR_CACHE[key] = op
    return op


def _band_planes(g, a, b, planes, diag, offdiag, coeff_dtype, device, cols=(0, None)):
    """The coefficient planes of padded rows [a, b) and columns [c0, c1) (``cols``, all
    by default), (5, b − a, c1 − c0): synthesized, or sliced from a whole (5, g, g) host
    array (a file's)."""
    lo, hi, pad = _real_rows(a, b, g)
    c0, c1 = cols[0], g if cols[1] is None else cols[1]
    if planes is None:
        return make_stencil5_planes_device(g, diag, offdiag, dtype=coeff_dtype, device=device,
                                           rows=(lo, hi), pad_rows=pad, cols=(c0, c1))
    src = torch.as_tensor(np.asarray(planes) if not torch.is_tensor(planes) else planes)
    if tuple(src.shape) != (5, g, g):
        raise ValueError(f"planes must be (5, {g}, {g}), got {tuple(src.shape)}")
    out = torch.zeros((5, b - a, c1 - c0), dtype=coeff_dtype, device=device)
    out[:, :hi - lo] = src[:, lo:hi, c0:c1].to(device=device, dtype=coeff_dtype)
    return out


# the modes of the 2-D decomposition: the stencils (the JAX package's ``_check_2d_mesh``)
MODES_2D = ("stencil5", "stencil5-bf16c", "stencil5-const")


def _check_2d_mesh(mesh_shape, g, mode, count) -> tuple:
    """(R, C) of a 2-D mesh of ``count`` shards, checked as the JAX package's
    ``_check_2d_mesh`` (``cg_sharded.py:797-810``): two axes, whose extents divide the grid
    (2-D padding is not implemented), a stencil mode, and here also R·C shards (the
    group's ranks, on the gloo transport).  ValueError otherwise."""
    try:
        nr, nc = (int(v) for v in mesh_shape)
    except (TypeError, ValueError):
        raise ValueError(f"2-D solver needs a 2-axis mesh (R, C), got {mesh_shape!r}") \
            from None
    if nr < 1 or nc < 1:
        raise ValueError(f"2-D solver needs a 2-axis mesh (R, C), got {mesh_shape!r}")
    if nr * nc != count:
        raise ValueError(f"a {nr}x{nc} mesh needs {nr * nc} ranks, the group has {count}")
    if g % nr or g % nc:
        raise ValueError(f"grid {g} must divide the mesh extents ({nr}, {nc}); use "
                         "cg_solve_sharded (1-D, pads remainders) otherwise")
    if mode not in MODES_2D:
        raise ValueError(f"2-D solver supports the stencil modes, got {mode}")
    return nr, nc


def _side_coeffs(mode, pieces, offdiag, dtype) -> tuple:
    """The coefficients of the west and east neighbours' columns, which only a 2-D block
    has: W[:, 0] and E[:, -1] of its planes in the state's dtype (its planes come from the
    global pattern, so an inner side column keeps its −1), or the constant offdiag."""
    if mode == "stencil5-const":
        return offdiag, offdiag
    return tuple(torch.cat([pl[d, :, c] for _, _, pl in pieces]).to(dtype)
                 for d, c in ((formats.W, 0), (formats.E, -1)))


def _make_ell_band(common, matrix, halo) -> ShardedOperator:
    """The ``csr`` band: this shard's rows as a slot-major ELL operand, columns rebased
    into the gather domain (the JAX package's ``_make_sharded_ell_operator`` and
    ``_ell_band_spmv``), its halo rows the domain's first and last (``halo``: the shard's
    ``_Halo`` given those buffers).  Pad rows: zero values, every column at the row
    itself."""
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
    return ShardedOperator(**common, overlap=False, halo=halo(g, domain[0:1], domain[-1:]),
                           ell_vals=vals, ell_cols=cols, domain=domain, nnz_actual=nnz)


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
# The mesh: every shard in this process
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class MeshOperator:
    """The sharded operator over a ``dist.Mesh`` that this process drives (the JAX
    package's ``ShardedOperator`` on its ``Mesh``): ``shards``, a ``ShardedOperator`` a
    shard (``make_sharded_operator(shard=(i, N))``), shard i on ``mesh.devices[i]``; row
    bands on a 1-D mesh, blocks on a 2-D one.  The shards' common attributes (grid_size,
    mode, dtype, band, cols, row_pad, nnz, ...) read as its own.  ``graphs``: its loops
    (``MeshLoop``, ``CardLoop``), dropped by ``free()``.

    ``solve`` and ``solve_stepped`` return the shards' fields, ``assemble`` the global
    field; ``exchange`` and ``sum`` are the mesh's transport."""

    mesh: dist.Mesh
    shards: tuple
    link: Optional["_RankLink"] = None
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    _SHARED = frozenset(("grid_size", "mode", "diag", "offdiag", "dtype", "band", "cols",
                         "row_pad", "nnz", "num_rows", "num_cols", "mesh_shape", "overlapped"))

    def __getattr__(self, name):
        if name in MeshOperator._SHARED:
            return getattr(self.shards[0], name)
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    @property
    def device(self) -> torch.device:
        """The first shard's device: the dots' sums, the loop's scalars, the global field."""
        return self.shards[0].device

    @property
    def one_card(self) -> bool:
        """Whether every shard is on one card (one graph can then hold the whole loop)."""
        return self.device.type == "cuda" and len(set(self.mesh.devices)) == 1

    def exchange(self, fields):
        """Fill every shard's halo buffers from its neighbours' ``fields``."""
        _mesh_exchange(self.shards, [f[0] for f in fields], [f[-1] for f in fields], fields,
                       self.link)

    def sum(self, parts):
        return _mesh_sum(parts, self.device, self.link)

    def sync(self) -> None:
        for d in {sh.device for sh in self.shards}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def solve(self, b=None, *, tolerance: float = 1e-6, max_iters: int = 1000,
              recompute_ap: Optional[bool] = None, use_pallas_blas1: Optional[bool] = None,
              graph: Optional[bool] = None, per_shard: bool = False):
        """One solve: (the shards' x fields, CGStats).  ``b``: None is b = ones, else the
        whole (g, g) field.  ``recompute_ap`` and ``use_pallas_blas1`` as in
        ``cg_solve_sharded``.  ``graph``: None runs the loop from CUDA graphs on the
        cards: with every shard on one card one graph (``MeshLoop``), with shards on
        several cards one graph a card, each replayed on its card (``CardLoop``); on the
        CPU, and on one card with ``use_pallas_blas1=False``, the eager loop.  True insists
        on a graph (ValueError where none can run); False runs the eager loop.
        ``per_shard``: the per-card loop even where every shard is on one card, which it
        then runs from one graph (on the CPU on the kernels' twins).  The per-card loop
        runs the BLAS1 kernels and needs peer access between its cards (ValueError
        otherwise).  A mesh across ranks (``dist.make_rank_mesh``) over NCCL
        (``rank_graph``; graph=None's choice there, with the BLAS1 kernels) runs one graph
        a rank where the rank's shards sit on one card of its own (``MeshLoop``), one
        graph a card where they sit on several (``RankCardLoop``), else the eager loop;
        ``graph=True`` raises ValueError where no graph can run (gloo ranks, ranks that
        share a card: the host steps them), ``per_shard=True`` always.  A capture that
        fails raises, and so does a solve whose waits passed their bound (a rank's replay
        that a peer never joined): nothing falls back."""
        loop = _pick_loop(self, recompute_ap)
        kernels = use_pallas_blas1 is not False
        cards = {d for d in self.mesh.devices if d.type == "cuda"}
        per_card = self.link is None and graph is not False and (per_shard or len(cards) > 1)
        if self.link is not None:
            key = self._rank_loop(loop, tolerance, max_iters, kernels, graph, per_shard)
        elif per_shard and graph is False:
            raise ValueError("per_shard=True runs a graph a shard; graph=False the eager loop")
        elif per_card:
            if not kernels:
                raise ValueError("the per-card loop runs the BLAS1 kernels; pass graph=False "
                                 "for the eager loop with use_pallas_blas1=False")
            if graph and not cards:
                raise ValueError("graph=True needs the shards on cards; the mesh is on "
                                 f"{sorted(map(str, self.mesh.devices))}")
            key = ("per card", loop, max_iters, tolerance)
            if key not in self.graphs:
                self.graphs[key] = CardLoop(self, loop, max_iters, tolerance)
        else:
            can = self.one_card and kernels
            if graph and not can:
                raise ValueError(f"graph=True needs every shard on one card and the BLAS1 "
                                 f"kernels; the mesh is on "
                                 f"{sorted(map(str, self.mesh.devices))}, "
                                 f"use_pallas_blas1={use_pallas_blas1}")
            graphed = can if graph is None else bool(graph)
            key = (loop, max_iters, tolerance, kernels, graphed)
            if key not in self.graphs:
                self.graphs[key] = MeshLoop(self, loop, max_iters, tolerance, kernels, graphed)
        t0 = time.perf_counter()
        try:
            with cg.solve_scope():
                xs, k, rr, bb = self.graphs[key].solve(b)
        except RuntimeError:
            # the per-card loop's epochs may disagree after a wait gave up, and a rank's
            # group is gone after a peer never came: make it anew
            if per_card or self.link is not None:
                self.graphs.pop(key, None)
            raise
        return xs, _cg_stats(k, rr, bb, tolerance, max_iters, t0)

    @property
    def rank_graph(self) -> bool:
        """Whether this rank's share of a mesh across ranks can run its loop from CUDA
        graphs: NCCL between the ranks (each rank's cards its own), the rank's shards on
        one card (one graph a rank) or on several (one graph a card)."""
        return self.link is not None and self.link.transport == "nccl"

    def _rank_loop(self, loop, tolerance, max_iters, kernels, graph, per_shard):
        """``solve``'s loop on a mesh across ranks, made at first use: from CUDA graphs
        (``rank_graph``, the BLAS1 kernels; ``graph`` None or True) ``MeshLoop`` with the
        rank link where the rank's shards sit on one card, ``RankCardLoop`` where they
        sit on several; else (``graph=False``, or where no graph can run) ``MeshLoop``
        eagerly."""
        if per_shard:
            raise ValueError("per_shard=True: a mesh across ranks runs the eager loop or, "
                             "over NCCL, one graph a rank or a card; the per-card loop "
                             "is one process's")
        if graph and not self.rank_graph:
            raise ValueError(f"graph=True: ranks over {self.link.transport} run the eager "
                             "loop: the host steps it, halos and dots pass through it; a "
                             "graph needs NCCL between ranks whose cards are their own")
        if graph and not kernels:
            raise ValueError("graph=True runs the BLAS1 kernels; pass graph=False for the "
                             "eager loop with use_pallas_blas1=False")
        graphed = self.rank_graph and kernels if graph is None else bool(graph)
        if graphed and len({sh.device for sh in self.shards}) > 1:
            key = ("rank cards", loop, max_iters, tolerance)
            if key not in self.graphs:
                self.graphs[key] = RankCardLoop(self, loop, max_iters, tolerance)
            return key
        key = (loop, max_iters, tolerance, kernels, graphed)
        if key not in self.graphs:
            self.graphs[key] = MeshLoop(self, loop, max_iters, tolerance, kernels, graphed)
        return key

    def solve_stepped(self, b=None, *, tolerance: float = 1e-6, max_iters: int = 1000,
                      verbose: int = 0):
        """The host-stepped classic loop over the mesh with its phase timers
        (``cg_solve_sharded_stepped``): (the shards' x fields, CGStats)."""
        return _stepped(self, b, tolerance, max_iters, verbose)

    def assemble(self, xs):
        """The global (g, g) field of the shards' fields, pad rows dropped, on the first
        shard's device: what the JAX package's solver returns.  On a mesh across ranks,
        the rank's bands stacked in order, pad rows kept (``dist.gather_to_host(x,
        rows=g)`` gives rank 0 the field), as a rank of one band returns its band; or its
        blocks, a tuple in shard order (``dist.gather_blocks_to_host(x, mesh.shape)``)."""
        if self.link is not None:
            if self.mesh_shape is not None:
                return tuple(xs)
            return torch.cat([x.to(self.device) for x in xs])
        g = self.grid_size
        out = torch.empty((g, g), dtype=self.dtype, device=self.device)
        for sh, x in zip(self.shards, xs):
            lo, hi, _ = _real_rows(sh.row_lo, sh.row_lo + sh.band, g)
            out[lo:hi, sh.col_lo:sh.col_lo + sh.cols].copy_(x[:hi - lo])
        return out

    def free(self) -> None:
        """Drop the captured loops (their fields, graphs and memory pools)."""
        self.graphs.clear()


def make_mesh_operator(grid_size: int, mesh: dist.Mesh, *, mode: str = "stencil5",
                       planes=None, matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                       dtype=torch.float32, overlap: bool = True,
                       transport: Optional[str] = None) -> MeshOperator:
    """The sharded operator over ``mesh`` (``dist.make_band_mesh`` for row bands,
    ``dist.make_mesh((R, C))`` for 2-D blocks), one shard a device of the mesh, as
    ``make_sharded_operator`` makes each (its refusals included).  On a mesh across ranks
    (``dist.make_rank_mesh``, bands or blocks) it holds this rank's shards and the link to
    the other ranks (``_RankLink``; ``transport`` as ``dist.device_group``'s, every rank
    calling it; "nccl" makes the link in a group of one rank too, whose dots NCCL then
    all-gathers, the one-card run of a graph a rank).  Cached for synthesized operands
    (``clear_caches``), with its captured loops."""
    if len(mesh.shape) not in (1, 2):
        raise ValueError(f"the sharded CG takes a 1-D or 2-D mesh, got shape {mesh.shape}")
    dtype = resolve_dtype(dtype)
    key = None
    if planes is None and matrix is None:
        key = ("mesh", int(grid_size), mode, diag, offdiag, dtype, overlap, mesh, transport)
        if key in _OPERATOR_CACHE:
            return _OPERATOR_CACHE[key]
    mesh_shape = mesh.shape if len(mesh.shape) == 2 else None
    shards = tuple(make_sharded_operator(grid_size, mode=mode, planes=planes, matrix=matrix,
                                         diag=diag, offdiag=offdiag, dtype=dtype,
                                         overlap=overlap, device=d, mesh_shape=mesh_shape,
                                         shard=(i, mesh.size))
                   for i, d in enumerate(mesh.devices) if i in mesh.local)
    op = MeshOperator(mesh, shards, _RankLink(shards, mesh.local.start, transport)
                      if mesh.processes > 1 or transport == "nccl" else None)
    if key is not None:
        _OPERATOR_CACHE[key] = op
    return op


def _current(device):
    """``device`` made the current card (a launch goes to its current stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _by_shard(shards):
    """(index, shard) of every shard, its device the current one while the caller's loop
    body runs for it."""
    for i, sh in enumerate(shards):
        with _current(sh.device):
            yield i, sh


def _mesh_exchange(shards, firsts, lasts, fields=None, link=None) -> None:
    """Fill every shard's halo buffers from its neighbours: its previous neighbour's last
    row (``lasts``), its next neighbour's first row (``firsts``) and, on a 2-D mesh, its
    west neighbour's last column and its east neighbour's first column of ``fields``, each
    in one copy (a strided column included); between cards a peer copy, which
    ``Tensor.copy_`` orders with CUDA events on both devices' streams.  On a mesh across
    ranks the lists are this rank's shards' (shard ``link.lo + k`` at position k), and
    ``link`` fills the halos whose neighbour lives on another rank, rows and columns."""
    lo = 0 if link is None else link.lo

    def local(j):
        return j is not None and lo <= j < lo + len(shards)

    with profiling.scope(profiling.PHASE_HALO):
        if link is not None:
            link.start(firsts, lasts, fields)
        for _, sh in _by_shard(shards):
            h = sh.halo
            if local(h.prev):
                h.halo_prev.copy_(lasts[h.prev - lo].reshape(h.halo_prev.shape))
            if local(h.next):
                h.halo_next.copy_(firsts[h.next - lo].reshape(h.halo_next.shape))
            if local(h.west):
                h.halo_w.copy_(fields[h.west - lo][:, -1])
            if local(h.east):
                h.halo_e.copy_(fields[h.east - lo][:, 0])
            HALO_CALLS["exchange"] += h.has_rows
            HALO_CALLS["column_exchange"] += h.has_cols
        if link is not None:
            link.finish()


def _mesh_sum(parts, device, link=None):
    """The shards' partials (0-d tensors) summed in shard order in their dtype, as a 0-d
    tensor on ``device``: each is copied there first (a peer copy from another card), as
    ``_allsum`` adds the ranks', so both transports give the same bits.  Never an
    ``all_reduce`` or an atomic add, whose order the hardware would pick.  On a mesh
    across ranks (``link``) every rank's partials, in global shard order (``_allsum`` over
    the link's transport)."""
    if link is not None:
        return _allsum(*parts, group=link.group).to(device)
    here = [t if t.device == device else _launch.buffer((), t.dtype, device).copy_(t)
            for t in parts]
    return _sum_in_order(here)


@dataclasses.dataclass(eq=False)
class _Piece:
    """One message of a ``_RankLink``: local shard ``k``'s row or column ``side`` (0: its
    first row, to the previous neighbour; 1: its last row, to the next; 2: its first
    column, to the west; 3: its last column, to the east) goes to rank ``peer``, and what
    that neighbour sends back lands in ``halo``.  ``send_tag``/``recv_tag`` name both
    messages by (sending shard, side): 4 · shard + side.  ``col``: the device buffer a
    column is gathered into; ``send``/``recv``: host staging (gloo) or, for a shard off
    the rank's first card, staging on that card (NCCL); None where the message needs
    none."""

    k: int
    side: int
    peer: int
    send_tag: int
    recv_tag: int
    halo: torch.Tensor
    col: Optional[torch.Tensor] = None
    send: Optional[torch.Tensor] = None
    recv: Optional[torch.Tensor] = None
    event: Optional[object] = None


class _RankLink:
    """What the ranks of a mesh across ranks pass each other (``dist.make_rank_mesh``: each
    rank drives shards [lo, lo + L) of one band or block mesh): for each local shard, and
    for each of its N/S/W/E neighbours that lives on another rank (rank = shard // L), one
    message each way (``_Piece``), a row of ``cols`` elements or a column of ``band``;
    between two ranks there may be several (two ranks × four blocks of a 4 × 2 mesh pass
    two rows each way).  Every buffer is made here, once.  All of an exchange's messages go
    in one ``batch_isend_irecv``, in one global order on both sides (by tag, which gloo
    also matches), over the transport of ``dist.device_group``:

      - ``nccl`` (every rank on cards of its own): device tensors, on the rank's first
        card (a shard on another of the rank's cards has its row copied there and its halo
        copied back); ``start`` sends, ``finish`` orders the current stream after NCCL's;
      - ``gloo``: ``start`` queues the D2H copies into pinned buffers, ``finish`` waits for
        them, swaps, and copies what arrived to the halo buffers.

    Dots go by ``_allsum`` over the same transport (``group``).  Over NCCL a call
    allocates nothing on the device (its list of messages is a host object), so a rank's
    captured loop holds ``start`` and ``finish``: ``finish``'s ``work.wait()`` makes the
    current stream wait for NCCL's, a dependency a capture records."""

    def __init__(self, shards, lo, transport=None):
        self.lo = lo
        n = len(shards)
        home = shards[0].device
        self.home = home
        self.group = dist.device_group([sh.device for sh in shards], transport)
        self.transport = "gloo" if self.group is None else "nccl"
        cuda = home.type == "cuda"
        self.pieces, self.works = [], []
        for k, sh in enumerate(shards):
            h, i = sh.halo, lo + k
            for side, nb, back, halo, size in ((0, h.prev, 1, h.halo_prev, sh.cols),
                                               (1, h.next, 0, h.halo_next, sh.cols),
                                               (2, h.west, 3, h.halo_w, sh.band),
                                               (3, h.east, 2, h.halo_e, sh.band)):
                if nb is None or lo <= nb < lo + n:
                    continue
                piece = _Piece(k, side, nb // n, 4 * i + side, 4 * nb + back, halo)
                if side >= 2 and sh.device.type == "cuda":
                    piece.col = torch.empty(size, dtype=sh.dtype, device=sh.device)
                if self.group is None:
                    piece.send, piece.recv = (torch.empty(size, dtype=sh.dtype,
                                                          pin_memory=cuda) for _ in range(2))
                    piece.event = torch.cuda.Event() if cuda else None
                elif sh.device != home:
                    piece.send, piece.recv = (torch.empty(size, dtype=sh.dtype, device=home)
                                              for _ in range(2))
                self.pieces.append(piece)
        self.sends = sorted(self.pieces, key=lambda p: p.send_tag)
        self.recvs = sorted(self.pieces, key=lambda p: p.recv_tag)

    def _source(self, piece, firsts, lasts, fields):
        """What ``piece`` sends: a row of the field (or of the recompute loop's rows), or a
        column gathered into its contiguous buffer."""
        k, side = piece.k, piece.side
        if side < 2:
            return (firsts if side == 0 else lasts)[k].reshape(-1)
        column = fields[k][:, 0 if side == 2 else -1]
        return column if piece.col is None else piece.col.copy_(column)

    def start(self, firsts, lasts, fields=None):
        """Send every piece of this rank's shards (``firsts``, ``lasts``, ``fields``: theirs,
        in local order): over NCCL the exchange itself, over gloo the D2H copies."""
        if not self.pieces:
            return
        sent = []
        for piece in self.sends:
            with _current(piece.halo.device):
                src = self._source(piece, firsts, lasts, fields)
                if self.group is not None:
                    sent.append(src if piece.send is None else piece.send.copy_(src))
                    continue
                piece.send.copy_(src, non_blocking=True)
                if piece.event is not None:
                    piece.event.record()
        if self.group is None:
            return
        ops = [tdist.P2POp(tdist.isend, t, p.peer, self.group, p.send_tag)
               for p, t in zip(self.sends, sent)]
        ops += [tdist.P2POp(tdist.irecv, p.halo.reshape(-1) if p.recv is None else p.recv,
                            p.peer, self.group, p.recv_tag) for p in self.recvs]
        with _current(self.home):
            self.works = tdist.batch_isend_irecv(ops)

    def finish(self):
        """The pieces' halos filled, once every message has arrived."""
        if not self.pieces:
            return
        if self.group is not None:
            with _current(self.home):
                for work in self.works:  # the current stream waits for NCCL's
                    work.wait()
            self.works = []
            for piece in self.recvs:
                if piece.recv is not None:
                    with _current(piece.halo.device):
                        piece.halo.copy_(piece.recv.reshape(piece.halo.shape))
            return
        for piece in self.sends:
            if piece.event is not None:
                piece.event.synchronize()
        ops = [tdist.P2POp(tdist.isend, p.send, p.peer, tag=p.send_tag) for p in self.sends]
        ops += [tdist.P2POp(tdist.irecv, p.recv, p.peer, tag=p.recv_tag) for p in self.recvs]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        for piece in self.recvs:
            with _current(piece.halo.device):
                piece.halo.copy_(piece.recv.reshape(piece.halo.shape), non_blocking=True)


def _spread(t, copies):
    """The 0-d tensor t on every shard's device: t itself where it is already there,
    else its copy (``copies``: a buffer a shard, None on t's device)."""
    return [t if c is None else c.copy_(t) for c in copies]


# how long a rank's host lets its replay of a graph a rank go without finishing an
# iteration (``MeshLoop._replay``), in seconds: far above one iteration's time (a
# quarter of 20480² f64 takes about 5 ms on a card), far below a hang; it bounds a stall,
# not a solve, whose length max_iters sets; read when a loop is made
RANK_WAIT_BOUND_S = 60.0
# how often that host reads the replay's k
RANK_POLL_S = 1e-3


def _watch(done, progress, bound_s, poll_s=RANK_POLL_S, clock=time.monotonic):
    """Wait until ``done()`` holds, then True; False once ``bound_s`` seconds pass with no
    new value of ``progress()`` (a counter's latest reading, None while none has come),
    called at most once every ``poll_s``: a bound on a stall, however long the work."""
    seen, since, polled = None, clock(), -poll_s
    while not done():
        now = clock()
        if now - polled >= poll_s:
            polled, value = now, progress()
            if value is not None and value != seen:
                seen, since = value, now
        if now - since > bound_s:
            return False
        time.sleep(0)
    return True


class MeshLoop(cg.DeviceLoop):
    """The sharded CG loop over a ``MeshOperator``'s shards in this process:
    ``cg.DeviceLoop``'s graph (a WHILE node, ``unroll`` iterations a body, the further
    ones under IF nodes, the condition set on the card) around an iteration that runs
    every shard's launches in turn, the classic or the recompute one.

    Its state is a field a shard (r, p, Ap, x, on each shard's device) and the scalars on
    the mesh's first device; a solve's x is a tuple of shard fields (``_new_x``).  An
    iteration calls, shard by shard, the wrappers the gloo ranks call, on the same
    operands, with α and β formed on the device from the same sums (``_mesh_sum``): the
    mesh and the gloo ranks give the same iterations and x bit for bit.  ``graphed``
    (every shard on one card): one replay and one read a solve; the body allocates
    nothing (every shard's dots take the workspace's buffers and its one ticket counter,
    safely, since they run in turn on one stream).  On a mesh across ranks (``link``)
    the graph is the rank's, over NCCL: the link's ``batch_isend_irecv`` and
    ``_allsum``'s all-gather are captured into the body on NCCL's stream, joined to the
    body's by events (``work.wait()``), their buffers made once.  Every iteration sits
    under an IF node of its own (``guard_first``): NCCL's stream stays in the capture it
    joined until that capture ends, and taking it again inside an IF body captured within
    the WHILE body's capture crashed the WHILE body's end of capture.  The capture is
    ``thread_local`` on a stream of the port's own, and the host lets a replay go at most
    ``bound_s`` without an iteration's end (``_replay``).  ``graphed`` on the CPU runs the
    graph's structure, each node's condition read on the host (``structured``; the
    tests).  Otherwise the iteration runs eagerly and the host reads the flag
    k < max_iters and rr > tol² once an iteration (``cg.COUNTS``).  ``kernels=False`` runs
    the BLAS1 steps as plain PyTorch ops, eagerly.

    The recompute loop forms each shard's two p′ rows that its neighbours need
    (``ShardedOperator.edge_rows``, from r and the previous p, which no kernel of the
    iteration has written yet) and exchanges them before any shard's K1 writes p′ into the
    other p buffer; the buffers alternate by the iteration's parity."""

    def __init__(self, op, loop, max_iters, tolerance, kernels=True, graphed=False,
                 unroll=cg.UNROLL):
        self._init_loop(loop, op.dtype, op.device, max_iters, tolerance, unroll)
        self.shards, self.link, self.kernels = op.shards, op.link, kernels
        # the graph's structure: captured on a card, run on the host's reading of each
        # node's condition on the CPU
        self.structured = graphed
        self.graphed = graphed and self.device.type == "cuda"
        # a rank's iterations hold NCCL's calls: each under an IF node of its own
        # (``cg.DeviceLoop.guard_first``)
        self.guard_first = self.link is not None
        if self.graphed and self.link is not None:
            # a rank's body holds NCCL's calls: its watchdog thread may query events while
            # the capture runs, which a "global" capture forbids; and the capture runs on
            # a stream of the port's own, never one of the pool NCCL's stream comes from
            self.capture_mode = "thread_local"
            self.capture_stream = graph_kernels.body_stream(self.device, "capture")
            # where the host reads k while a replay runs: a stream of its own, which the
            # replay's does not wait for, into pinned memory
            self.watch = torch.cuda.Stream(self.device)
            self.k_seen = torch.full((), -1, dtype=self.k.dtype, pin_memory=True)
        self.bound_s = RANK_WAIT_BOUND_S
        self.withheld = False  # a test's rank that never replays its graph
        self.r = self._new_x()
        self.p = ((tuple(sh.p_buffer() for sh in self.shards),) if loop == "classic"
                  else (self._new_x(), self._new_x()))
        self.ap = None if loop == "recompute" else self._new_x()
        self.edges = tuple(  # the recompute loop's p' rows for the neighbours
            torch.empty((min(sh.band, 2), sh.cols), dtype=self.dtype, device=sh.device)
            for sh in self.shards) if loop == "recompute" else ()
        self.copies = tuple(None if sh.device == self.device else
                            torch.empty((), dtype=self.alpha.dtype, device=sh.device)
                            for sh in self.shards)

    def _new_x(self):
        return tuple(torch.empty(sh.field_shape, dtype=self.dtype, device=sh.device)
                     for sh in self.shards)

    def solve(self, b=None):
        """One solve from b = ones (None) or the whole (g, g) field b, of which the start
        cuts each shard's part (``ShardedOperator.band_of``): (the shards' x fields,
        iterations, rr, <b, b>), the last two Python floats."""
        return self._run(lambda x: self._start(x, b))

    def _dot(self):
        return blas1.dot if self.kernels else blas1.dot_plain

    def _start(self, x, b):
        """r0 = b, x0 = 0, <r0, r0> (each shard's K6, summed in shard order), <b, b>, tol²,
        k = 0 and the loop's first p into the state, eagerly, as the gloo ranks start."""
        dot = self._dot()
        rrs = []
        for i, sh in _by_shard(self.shards):
            if b is None:
                sh.ones_b(out=self.r[i])
            else:
                self.r[i].copy_(sh.band_of(b))
            x[i].zero_()
            rrs.append(dot(self.r[i], self.r[i]))
            if self.loop == "classic":
                self.p[0][i].copy_(self.r[i])
            else:
                self.p[1][i].zero_()  # the first iteration's p_prev: p' = r + 0·0
        rr = _mesh_sum(rrs, self.device, self.link)
        self.rr.copy_(rr)
        self.bb.copy_(rr)
        torch.mul(self.bb, self.tolerance * self.tolerance, out=self.tol2)
        self.k.zero_()
        self.rr_prev.fill_(1)

    def _capture(self, x):
        """``cg.DeviceLoop``'s capture, with the halo counts set apart as it sets the
        launches apart: a replay adds one captured iteration's k times (``_count_replay``)."""
        before = dict(HALO_CALLS)
        runs = self.unroll + (self.workspace is None)  # the first also records an iteration
        try:
            return super()._capture(x)
        finally:
            self.halo_per_iteration = {n: (v - before[n]) // runs
                                       for n, v in HALO_CALLS.items()}
            HALO_CALLS.update(before)

    def _count_replay(self, k):
        super()._count_replay(k)
        for name, n in self.halo_per_iteration.items():
            HALO_CALLS[name] += n * k

    def _replay(self, graph):
        """The replay; on a rank, the host then waits for it as long as it finishes an
        iteration at least once every ``bound_s``: a peer that never comes to a captured
        exchange or sum would hang it, and NCCL's watchdog does not watch captured calls.
        A solve of any length passes; a stall aborts the group's communicator
        (``dist.abort_nccl``, on a thread of its own) and the solve raises at once."""
        if not self.withheld:
            graph.replay()
        if self.link is None:
            return
        done = torch.cuda.Event()
        done.record()
        if not _watch(done.query, self._k_now, self.bound_s):
            dist.abort_nccl(self.link.group)
            raise RuntimeError(
                f"rank {dist.rank()}: the sharded CG's {self.loop} solve, replayed from its "
                f"graph, finished no iteration for its bound of {self.bound_s:g} s (k stayed "
                f"{int(self.k_seen)}): a rank never came to its exchanges and sums (NCCL's "
                "communicator is aborted)")

    def _k_now(self):
        """The replay's k as the last read of it found it (None while that read is still
        under way), the next read queued on the watch stream: a copy engine's read of the
        card's k while the graph runs, neither a sync nor a read the loop steers by."""
        if not self.watch.query():
            return None
        k = int(self.k_seen)
        with torch.cuda.stream(self.watch):
            self.k_seen.copy_(self.k, non_blocking=True)
        return k

    def _run_host(self, x):
        """The graph's structure with each node's condition read on the host
        (``structured``, on the CPU), else the eager loop: an iteration at a time, each
        after one counted read of the flag k < max_iters and rr > tol²."""
        if self.structured:
            super()._run_host(x)
            return
        parity = 0
        while bool(cg._read((self.k < self.max_iters) & (self.rr > self.tol2))):
            self._iteration(x, parity)
            parity ^= 1

    def _iteration(self, x, parity):
        if self.loop == "classic":
            rr_new = self._classic(x)
        else:
            rr_new = self._recompute(x, self.p[parity], self.p[1 - parity])
            self.rr_prev.copy_(self.rr)
        self.rr.copy_(rr_new)
        self.k.add_(1)

    def _classic(self, x):
        """The classic iteration: the exchange of p's halos, every shard's SpMV with its
        dot, <p, A·p>, α, every shard's K4, <r, r>, β, every shard's K5."""
        shards, r, p, ap, rr = self.shards, self.r, self.p[0], self.ap, self.rr
        cg_update = blas1.cg_update if self.kernels else blas1.cg_update_plain
        p_update = blas1.p_update if self.kernels else blas1.p_update_plain
        with profiling.scope(profiling.PHASE_SPMV):
            _mesh_exchange(shards, [f[0] for f in p], [f[-1] for f in p], p, self.link)
            paps = [sh.spmv_dot(p[i], ap[i], sh.halo.halos) for i, sh in _by_shard(shards)]
        torch.div(rr, _mesh_sum(paps, self.device, self.link), out=self.alpha)
        alphas = _spread(self.alpha, self.copies)
        with profiling.scope(profiling.PHASE_AXPY):
            rrs = [cg_update(alphas[i], x[i], r[i], p[i], ap[i])[2]
                   for i, _ in _by_shard(shards)]
        rr_new = _mesh_sum(rrs, self.device, self.link)
        torch.div(rr_new, rr, out=self.beta)
        betas = _spread(self.beta, self.copies)
        with profiling.scope(profiling.PHASE_UPDATE_P):
            for i, _ in _by_shard(shards):
                p_update(betas[i], r[i], p[i])  # p = r + β·p
        return rr_new

    def _recompute(self, x, p, p_prev):
        """The recompute iteration: β (0 on the first), each shard's two p′ rows exchanged,
        every shard's K1 (p′ into ``p``, <p′, A·p′>), α, every shard's K2 (x, r, <r, r>)."""
        shards, r, rr = self.shards, self.r, self.rr
        kw = {"diag": shards[0].diag, "offdiag": shards[0].offdiag}
        torch.eq(self.k, 0, out=self.first)
        torch.div(rr, self.rr_prev, out=self.beta)
        torch.where(self.first, self.zero, self.beta, out=self.beta)  # β = 0 on the first
        betas = _spread(self.beta, self.copies)
        if any(sh.halo.has_rows for sh in shards):
            for i, sh in _by_shard(shards):
                sh.edge_rows(r[i], p_prev[i], betas[i], out=self.edges[i])
            _mesh_exchange(shards, [e[0] for e in self.edges], [e[-1] for e in self.edges],
                           link=self.link)
        paps = []
        with profiling.scope(profiling.PHASE_SPMV):
            for i, sh in _by_shard(shards):
                hp, hn = sh.halo.halo_prev, sh.halo.halo_next
                paps.append(_st5.spmv_stencil5_const_pupdate_dot(
                    betas[i], r[i], p_prev[i], hp, hn, out=p[i], **kw)[1])
                sh.halo.count("spmv_stencil5_const_pupdate_dot", hp, hn)
        torch.div(rr, _mesh_sum(paps, self.device, self.link), out=self.alpha)
        alphas = _spread(self.alpha, self.copies)
        rrs = []
        with profiling.scope(profiling.PHASE_AXPY):
            for i, sh in _by_shard(shards):
                hp, hn = sh.halo.halo_prev, sh.halo.halo_next
                rrs.append(_st5.cg_const_update_recompute(alphas[i], x[i], r[i], p[i], hp,
                                                          hn, **kw)[2])
                sh.halo.count("cg_const_update_recompute", hp, hn)
        return _mesh_sum(rrs, self.device, self.link)


# ---------------------------------------------------------------------------
# The per-card loop: one graph a card, the cards meeting through each other's memory
# ---------------------------------------------------------------------------

# how long a wait of the per-card loop may spin (``CardLoop``), in seconds: far above an
# iteration's time on any mesh, far below a hang; read when a loop is made
WAIT_BOUND_S = 5.0
# the sync points of an iteration, as a wait's error word names them (the word is
# 16 · (shard + 1) + point)
SYNC_POINTS = {1: "rows", 2: "<p, A·p>", 3: "<r, r>"}


def _enable_peers(devices) -> None:
    """Peer access between every two cards of ``devices``, both ways (a shard's partials
    reach every shard): ValueError naming the first pair that has none, before any access
    is enabled."""
    cards = sorted({torch.cuda.current_device() if d.index is None else d.index
                    for d in devices if d.type == "cuda"})
    pairs = [(a, b) for a in cards for b in cards if a != b]
    for a, b in pairs:
        if not torch.cuda.can_device_access_peer(a, b):
            raise ValueError(f"the per-card loop needs peer access from cuda:{a} to cuda:{b}, "
                             "which this machine does not give (graph=False runs the eager "
                             "loop)")
    for a, b in pairs:
        mesh_sync.enable_peer(a, b)


class _CardShard(cg.DeviceLoop):
    """One shard's part of a ``CardLoop``, all of it on the shard's device: its state (r,
    p, Ap, the recompute loop's p′ rows, rr, the previous rr, <b, b>, tol², α, β, k, and
    the two sums it waits for) and its sync state (``ctl``: the epoch and the error word;
    ``flags``: one a neighbour's rows, in the order previous, next, west, east, then one a
    shard for each dot; ``partials``: a slot a shard for each dot).  Its card's graph
    (``_Card``) runs its iterations."""

    def __init__(self, owner, index, sh, n):
        self._init_loop(owner.loop, sh.dtype, sh.device, owner.max_iters, owner.tolerance,
                        owner.unroll)
        self.index, self.sh = index, sh
        self.shape = tuple(sh.field_shape)
        self.r = self._new_x()
        self.p = ((sh.p_buffer(),) if self.loop == "classic"
                  else (self._new_x(), self._new_x()))
        self.ap = None if self.loop == "recompute" else self._new_x()
        self.edges = (torch.empty((min(sh.band, 2), sh.cols), dtype=self.dtype,
                                  device=self.device) if self.loop == "recompute" else None)
        acc = self.rr.dtype
        self.pap, self.rr_new = (torch.empty((), dtype=acc, device=self.device)
                                 for _ in range(2))
        self.ctl = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.flags = torch.zeros(4 + 2 * n, dtype=torch.int64, device=self.device)
        self.row_flags = self.flags[:4]
        self.dot_flags = (self.flags[4:4 + n], self.flags[4 + n:])
        self.partials = torch.zeros((2, n), dtype=acc, device=self.device)
        h = sh.halo
        self.mask = sum(1 << bit for bit, j in enumerate((h.prev, h.next, h.west, h.east))
                        if j is not None)
        self.rows = self.dests = None  # its links, made once every shard has its buffers
        self.rows_epoch = 0  # on the CPU: the epoch of the rows its kernels read


class _Card(cg.DeviceLoop):
    """One card's part of a ``CardLoop``: its shards (``members``, ``_CardShard`` in shard
    order) and their graph, captured by ``cg.DeviceLoop``'s machinery on a stream of the
    card and replayed on another.  An iteration runs the live shards (those not withheld)
    in lockstep (``CardLoop._lockstep``), so one stream holds them all; the condition of
    its nodes reads the first live shard's k, rr and tol², which every shard holds bit for
    bit.  What a capture records depends on the withheld shard: ``variants`` keeps, for
    each, the workspace, the launches and the halo counts of one captured iteration.  It
    refers to its loop weakly: a cycle would leave the graphs to the cyclic garbage
    collector, whose destruction of a graph during another capture breaks that capture."""

    def __init__(self, owner, members):
        lead = members[0]
        self._init_loop(owner.loop, lead.dtype, lead.device, owner.max_iters,
                        owner.tolerance, owner.unroll)
        self.owner, self.members = weakref.ref(owner), tuple(members)
        self.variants = {}
        if self.device.type == "cuda":
            self.capture_stream = graph_kernels.body_stream(self.device, "capture")
            self.stream = graph_kernels.body_stream(self.device, "card")

    def live(self):
        """The card's shards that a solve runs: all but the withheld one."""
        withheld = self.owner().withheld
        return [s for s in self.members if s.index != withheld]

    def _cond_state(self):
        lead = self.live()[0]
        return lead.k, self.max_iters, lead.rr, lead.tol2

    def _iteration(self, xs, parity):
        """One iteration of the card's live shards, each sync op launched, except in the
        eager pass that records the workspace, which leaves them out (it must not wait for
        cards that are not running)."""
        dry, owner = self.workspace.recording, self.owner()
        for op in owner._lockstep(self.live(), xs, parity):
            if not dry:
                op(owner.bound_ns)

    def _capture(self, xs):
        """``cg.DeviceLoop``'s capture on the card, with the halo counts set apart as it
        sets the launches apart, into the variant of the withheld shard."""
        key = self.owner().withheld
        self.workspace, self.per_iteration, halo = self.variants.get(key, (None, None, {}))
        before = dict(HALO_CALLS)
        runs = self.unroll + (self.workspace is None)  # the first also records an iteration
        with torch.cuda.device(self.device):
            mesh_sync.preload(self.device)
            try:
                graph = super()._capture(xs)
            finally:
                halo = {n: (v - before[n]) // runs for n, v in HALO_CALLS.items()}
                HALO_CALLS.update(before)
        self.variants[key] = (self.workspace, self.per_iteration, halo)
        return graph

    def count_replay(self, k, key):
        """A replay of k iterations of the variant ``key``: its launches and halo counts."""
        _ws, self.per_iteration, halo = self.variants[key]
        self._count_replay(k)
        for name, v in halo.items():
            HALO_CALLS[name] += v * k


class CardLoop:
    """The sharded CG loop with one CUDA graph a card, each replayed on its card: the
    counterpart of the JAX package's ``shard_map``-wrapped ``lax.while_loop``, in which
    every device runs the loop and ``psum`` hands each the same sums.  A WHILE node's body
    may hold kernels of one device only, so no one graph spans the cards.

    Each shard (``_CardShard``) keeps its own copy of the loop's state and scalars on its
    card.  Each card (``_Card``) runs ``cg.DeviceLoop``'s graph over its shards: a WHILE
    node, ``unroll`` iterations a body, the further ones under IF nodes, each condition set
    by the card from its first shard's rr.  An iteration makes the eager mesh's calls in
    its order (``MeshLoop``) for every shard of the card, with the mesh's transport
    replaced by three sync points (``kernels/mesh_sync.py``): the rows (each shard stores
    its boundary rows, and on a 2-D mesh its side columns, into its neighbours' halo
    buffers, then waits for theirs), <p, A·p> and <r, r> (each shard stores its partial
    into its slot of every shard's slots, then waits for all and adds them in shard order
    itself: ``_mesh_sum``'s bits everywhere).  The card's shards meet each sync point in
    lockstep (``_lockstep``): all of them run their steps up to it, all publish, and only
    then does any wait, so a wait finds the flags of its own card's shards set in stream
    order and spins only for other cards, which run at once.  α and β are then formed on
    every card by the same torch ops, so every card holds the same scalars, evaluates the
    same condition and runs the same iterations.  No host read, host copy or event
    fork-join remains inside a solve: its start runs eagerly as the mesh's (its sums
    copied into every shard's scalars), then every card's graph is replayed on a stream of
    its own with no host wait between them, then one read (every shard's rr, <b, b>, k and
    error word) ends it: one replay a card and one read a solve.  Shards that disagree, or
    a wait that passed its bound (``WAIT_BOUND_S``), raise RuntimeError.

    Why no write can land before its reader is done with the last one (k the iteration;
    a shard's three sync points in an iteration come in the order rows, <p, A·p>, <r, r>,
    and each wait needs every writer's publish of that sync point; lockstep is one order of
    the shards' steps that keeps each shard's own order):

      - a shard's halo buffers (rows, columns): the neighbour writes them at the rows
        point of k + 1, after its wait at <r, r> of k, which needs the shard's <r, r>
        publish of k, which follows the shard's last read of the halos in k (the SpMV in
        the classic loop, K1 and K2 in the recompute loop);
      - a shard's <p, A·p> slots: another shard writes them at k + 1 after its wait at
        <r, r> of k, which needs this shard's <r, r> publish of k, which follows its sum
        of the <p, A·p> slots in k;
      - a shard's <r, r> slots: another shard writes them at k + 1 after its wait at
        <p, A·p> of k + 1, which needs this shard's <p, A·p> publish of k + 1, which
        follows its sum of the <r, r> slots in k;
      - a flag: written by its one writer, after its data, to the epoch of the sync point,
        which rises by one at every sync point on every shard alike and never falls.

    On the CPU (the tests) ``solve`` runs the same steps on the kernels' twins: every
    card's program (``cg.DeviceLoop``'s structure, each node's condition read on the host,
    its shards in lockstep) is a coroutine that stops at each sync op, and ``_run_host``
    interleaves them, the lowest card that can go on first, or as ``schedule`` (a
    ``random.Random``) picks; when every card waits for another, the bound has passed.
    ``card_of``: the model card of each shard, one a shard unless a test says otherwise
    (on the cards, each shard's card, by device).  Every read of a halo row there checks
    its flags' epoch (``mesh_sync.check_epochs``), every sum its slots'.  ``withheld``: a
    shard whose steps a solve leaves out (from its card's graph or program; a card with no
    other shard is not replayed), to test the bound."""

    def __init__(self, op, loop, max_iters, tolerance, unroll=cg.UNROLL):
        self.loop, self.max_iters, self.tolerance, self.unroll = loop, max_iters, tolerance, \
            unroll
        self.shards, self.device, self.dtype = op.shards, op.device, op.dtype
        self.link = op.link
        self.lo = 0 if op.link is None else op.link.lo  # the first shard's global index
        self.exchanging = op.mesh.size > 1  # a rows sync point in every iteration
        self.graphed = self.device.type == "cuda"
        if self.graphed:
            _enable_peers([sh.device for sh in self.shards])
        slots = self._dot_slots()
        self.parts = tuple(_CardShard(self, i, sh, slots) for i, sh in enumerate(self.shards))
        self._make_links()
        self.bound_ns = int(WAIT_BOUND_S * 1e9)
        places = [s.device for s in self.parts] if self.graphed else list(range(len(self.parts)))
        self.card_of = self._by_device = tuple(places.index(d) for d in places)
        self._cards = {}
        self.solutions = {}  # the withheld shard -> its solution slots
        self.schedule = None
        self.withheld = None

    def _dot_slots(self) -> int:
        """The slots of a shard's dot sync point: one a shard, each shard's partial."""
        return len(self.shards)

    def _make_links(self):
        """Every shard's links: its rows (a mesh of more than one shard) and, for each
        dot, its partial (``_dot_items``)."""
        for i, s in enumerate(self.parts):
            if self.exchanging:
                src = s.p[0] if self.loop == "classic" else s.edges
                s.rows = mesh_sync.row_links(self._row_items(i, src), s.device)
            s.dests = tuple(mesh_sync.partial_links(self._dot_items(i, d), s.device)
                            for d in (0, 1))

    def _dot_items(self, i, d):
        """(slot, flag) of shard i's partial of dot d: its slot of every shard's slots."""
        return [(t.partials[d, i], t.dot_flags[d][i]) for t in self.parts]

    def _row_items(self, i, src):
        """(source, destination, flag) of shard i's rows: its first row into its previous
        neighbour's next halo, its last into its next neighbour's previous halo, its first
        and last columns into its west and east neighbours' halo columns; a neighbour on
        another rank gets it through the rank link (``_outbound``)."""
        h, items = self.shards[i].halo, []
        for j, side, row, name, flag in ((h.prev, 0, src[0], "halo_next", 1),
                                         (h.next, 1, src[-1], "halo_prev", 0),
                                         (h.west, 2, src[:, 0], "halo_e", 3),
                                         (h.east, 3, src[:, -1], "halo_w", 2)):
            if j is None:
                continue
            k = j - self.lo
            if 0 <= k < len(self.parts):
                items.append((row, getattr(self.shards[k].halo, name).view(-1),
                              self.parts[k].row_flags[flag]))
            else:
                items.append((row, *self._outbound(i, side)))
        return items

    def _outbound(self, i, side):
        """(destination, flag) of shard i's row ``side`` for a neighbour on another rank:
        only a mesh across ranks has one (``RankCardLoop``)."""
        raise AssertionError(f"shard {self.lo + i}'s neighbour on side {side} is not here")

    def cards(self):
        """The cards of ``card_of`` (``_Card``, in the order of their first shard), made
        at first use; ValueError on the cards for any other map than the devices'."""
        key = tuple(self.card_of)
        if key not in self._cards:
            if self.graphed and key != self._by_device:
                raise ValueError("on the cards, a shard's card is its device's")
            self._cards[key] = tuple(_Card(self, [s for s in self.parts if key[s.index] == c])
                                     for c in dict.fromkeys(key))
        return self._cards[key]

    def solve(self, b=None):
        """One solve from b = ones (None) or the whole (g, g) field b (``MeshLoop.solve``):
        (the shards' x fields, iterations, rr, <b, b>), the last two Python floats; the
        spans of ``cg.DeviceLoop``'s solve."""
        with profiling.scope(profiling.PHASE_SLOT):
            slot = self._slot()
        with profiling.scope(profiling.PHASE_START):
            self._start(slot.x, b)
        with profiling.scope(profiling.PHASE_REPLAY):
            if slot.graph is None:
                self._run_host(slot.x)
            else:
                self._replay(slot.graph)
        with profiling.scope(profiling.PHASE_READ):
            return (slot.x, *self._read(slot.graph))

    def _slot(self):
        slots = self.solutions.setdefault(self.withheld, [])
        for slot in slots:
            if slot.free():
                return slot
        slot = cg._Slot.of(tuple(s._new_x() for s in self.parts))
        if self.graphed:  # None for a card whose only shards are withheld
            slot.graph = tuple(card._capture(slot.x) if card.live() else None
                               for card in self.cards())
        slots.append(slot)
        return slot

    def _start(self, xs, b):
        """The mesh's start (``MeshLoop._start``), eagerly: each shard's r0, x0 and
        <r0, r0> (K6), the sum in shard order, then <r0, r0>, <b, b>, tol², k = 0 and the
        previous rr into every shard's scalars."""
        rrs = []
        for i, sh in _by_shard(self.shards):
            s = self.parts[i]
            if b is None:
                sh.ones_b(out=s.r)
            else:
                s.r.copy_(sh.band_of(b))
            xs[i].zero_()
            rrs.append(blas1.dot(s.r, s.r))
            if self.loop == "classic":
                s.p[0].copy_(s.r)
            else:
                s.p[1].zero_()  # the first iteration's p_prev: p' = r + 0·0
        rr = _mesh_sum(rrs, self.device, self.link)
        for s in self.parts:
            with _current(s.device):
                s.rr.copy_(rr)
                s.bb.copy_(rr)
                torch.mul(s.bb, self.tolerance * self.tolerance, out=s.tol2)
                s.k.zero_()
                s.rr_prev.fill_(1)

    def _replay(self, graphs):
        """Every card's graph replayed on its own stream of its card, after the start and
        before the read, none waiting for another's launch or for the host."""
        played = [(card, g) for card, g in zip(self.cards(), graphs) if g is not None]
        for card, g in played:
            card.stream.wait_stream(torch.cuda.current_stream(card.device))
            with torch.cuda.stream(card.stream):
                g.replay()
        for card, _g in played:
            torch.cuda.current_stream(card.device).wait_stream(card.stream)
        cg.COUNTS["replays"] += len(played)

    def _read(self, graphs):
        """The solve's one read, every shard's rr, <b, b>, k and error word: (k, rr,
        <b, b>); RuntimeError for a wait past its bound or shards that disagree.  After a
        replay, the cards' launches and halo counts (``graphs``: the slot's)."""
        rows = [torch.stack([s.rr.double(), s.bb.double(), s.k.double(),
                             s.ctl[1].double()]).to(self.device) for s in self.parts]
        rows += [torch.stack([w.double()] * 4).to(self.device) for w in self._error_words()]
        status = cg._read(torch.stack(rows)).tolist()
        errors = [int(row[3]) for row in status if row[3]]
        status = status[:len(self.parts)]
        if errors:
            raise RuntimeError("the per-card loop stopped: " + "; ".join(
                f"{self._waiter(e)}'s wait at {SYNC_POINTS.get(e % 16, e % 16)} passed its "
                "bound" for e in errors) + f" (a shard's bound {self.bound_ns / 1e9:g} s; a "
                "shard did not publish)")
        ks = {int(row[2]) for row in status}
        if len(ks) > 1 or len({repr(row[0]) for row in status}) > 1:
            raise RuntimeError(f"the shards disagree: k {[int(r[2]) for r in status]}, rr "
                               f"{[r[0] for r in status]}")
        k = ks.pop()
        for card, g in zip(self.cards(), graphs or ()):
            if g is not None:
                card.count_replay(k, self.withheld)
        return k, status[0][0], status[0][1]

    def _error_words(self):
        """0-d int64 error words beside the shards' that the solve's read takes: none."""
        return ()

    def _waiter(self, code) -> str:
        """Who made a wait whose error word is ``code`` (``_code``)."""
        return f"shard {code // 16 - 1 + self.lo}"

    # -- the iteration, as each shard runs it --------------------------------------------

    def _lockstep(self, members, xs, parity):
        """One iteration of a card's shards ``members`` in lockstep, as a generator of
        their sync ops: at each sync point, every shard's steps up to it, then every
        shard's publish, then every shard's wait, in shard order (``_steps`` yields a
        publish and its wait with no step between them)."""
        steps = [self._steps(s.index, xs[s.index], parity) for s in members]
        rounds = 0
        while True:
            ops = [next(step, None) for step in steps]
            if all(op is None for op in ops):
                return
            if None in ops:
                raise RuntimeError("the shards of a card fell out of step")
            yield from ops
            if rounds % 2 == 0:  # every shard has published; their waits come next
                yield from self._between(members, rounds // 2)
            rounds += 1

    def _between(self, members, point):
        """The card's sync ops between its shards' publishes and their waits at the
        iteration's ``point``-th sync point: none (``RankCardLoop``'s home card has its
        link's)."""
        del members, point
        return ()

    def _steps(self, i, x, parity):
        """Shard i's iteration, the eager mesh's calls in its order, as a generator of its
        sync ops: each is ``op(bound_ns)``, True once it went through (a launch at once; a
        twin's wait only when its flags are there)."""
        s, sh = self.parts[i], self.shards[i]
        if self.loop == "classic":
            p = s.p[0]
            if self.exchanging:
                yield from self._exchange(s)
            with profiling.scope(profiling.PHASE_SPMV):
                self._check_rows(s)
                pap = sh.spmv_dot(p, s.ap, sh.halo.halos)
            yield from self._allsum(s, 0, pap, s.pap)
            torch.div(s.rr, s.pap, out=s.alpha)
            with profiling.scope(profiling.PHASE_AXPY):
                rr_local = blas1.cg_update(s.alpha, x, s.r, p, s.ap)[2]
            yield from self._allsum(s, 1, rr_local, s.rr_new)
            torch.div(s.rr_new, s.rr, out=s.beta)
            with profiling.scope(profiling.PHASE_UPDATE_P):
                blas1.p_update(s.beta, s.r, p)  # p = r + β·p
        else:
            p, p_prev = s.p[parity], s.p[1 - parity]
            kw = {"diag": sh.diag, "offdiag": sh.offdiag}
            torch.eq(s.k, 0, out=s.first)
            torch.div(s.rr, s.rr_prev, out=s.beta)
            torch.where(s.first, s.zero, s.beta, out=s.beta)  # β = 0 on the first
            if self.exchanging:
                sh.edge_rows(s.r, p_prev, s.beta, out=s.edges)
                yield from self._exchange(s)
            hp, hn = sh.halo.halo_prev, sh.halo.halo_next
            with profiling.scope(profiling.PHASE_SPMV):
                self._check_rows(s)
                pap = _st5.spmv_stencil5_const_pupdate_dot(s.beta, s.r, p_prev, hp, hn, out=p,
                                                           **kw)[1]
                sh.halo.count("spmv_stencil5_const_pupdate_dot", hp, hn)
            yield from self._allsum(s, 0, pap, s.pap)
            torch.div(s.rr, s.pap, out=s.alpha)
            with profiling.scope(profiling.PHASE_AXPY):
                self._check_rows(s)
                rr_local = _st5.cg_const_update_recompute(s.alpha, x, s.r, p, hp, hn, **kw)[2]
                sh.halo.count("cg_const_update_recompute", hp, hn)
            yield from self._allsum(s, 1, rr_local, s.rr_new)
            s.rr_prev.copy_(s.rr)
        s.rr.copy_(s.rr_new)
        s.k.add_(1)

    def _exchange(self, s):
        """The rows sync point (a mesh of more than one shard): publish the shard's rows,
        wait for its neighbours'."""
        yield functools.partial(_publish, mesh_sync.publish_rows, (s.ctl, s.rows))
        yield functools.partial(mesh_sync.wait, s.ctl, s.row_flags, s.mask, _code(s, 1))
        h = s.sh.halo
        HALO_CALLS["exchange"] += h.has_rows
        HALO_CALLS["column_exchange"] += h.has_cols
        if not self.graphed:
            s.rows_epoch = int(s.ctl[0])

    def _allsum(self, s, d, part, out):
        """A dot's sync point (d 0: <p, A·p>, 1: <r, r>): publish the shard's partial, wait
        for every shard's and add them in shard order into ``out``."""
        yield functools.partial(_publish, mesh_sync.publish_partial, (s.ctl, part, s.dests[d]))
        yield functools.partial(mesh_sync.wait, s.ctl, s.dot_flags[d],
                                (1 << s.partials.shape[1]) - 1, _code(s, 2 + d),
                                slots=s.partials[d], out=out)

    def _check_rows(self, s):
        """On the CPU, before a kernel reads the halos: their flags hold the epoch of the
        rows sync point of this iteration (unless a wait gave up: the solve raises)."""
        if not self.graphed and s.rows is not None and not int(s.ctl[1]):
            mesh_sync.check_epochs(s.row_flags, s.mask, s.rows_epoch)

    # -- the loop on the CPU ---------------------------------------------------------------

    def _program(self, card, xs):
        """A card's loop on the host: ``cg.DeviceLoop._structure``'s nodes, each condition
        read on the host from the card's first live shard, its shards' iterations in
        lockstep, their sync ops yielded."""
        live = card.live()

        def cond():
            return graph_kernels.cond_plain(*card._cond_state())

        while cond():
            yield from self._lockstep(live, xs, 0)
            for j in range(1, self.unroll):
                if cond():
                    yield from self._lockstep(live, xs, j % 2)

    def _run_host(self, xs):
        """Every card's program, interleaved at its sync ops: the lowest card that can go
        on runs (or the one ``schedule`` picks), until each is done; when every card waits
        for another, the bound has passed and their waits take the error path."""
        progs = {c: self._program(card, xs) for c, card in enumerate(self.cards())
                 if card.live()}
        ops, blocked = {}, set()

        def advance(c):
            op = next(progs[c], None)
            if op is None:
                ops.pop(c, None)
            else:
                ops[c] = op

        for c in progs:
            advance(c)
        while ops:
            ready = sorted(set(ops) - blocked)
            if not ready:
                for c in sorted(blocked):
                    ops[c](0)
                    advance(c)
                blocked.clear()
                continue
            c = ready[0] if self.schedule is None else self.schedule.choice(ready)
            if ops[c](self.bound_ns):
                advance(c)
                blocked.clear()
            else:
                blocked.add(c)


class RankCardLoop(CardLoop):
    """The per-card loop of a rank whose shards of a mesh across ranks sit on several
    cards of its own, over NCCL (``MeshOperator.rank_graph`` and more than one card):
    one CUDA graph a card, as ``CardLoop`` runs a process's mesh, joined to the other
    ranks by NCCL's calls captured into one graph only, the home card's (``_RankLink.home``,
    the rank's first card, where its NCCL group runs).  Each JAX process runs one
    compiled ``while_loop`` over all its local devices; a WHILE node's body holds kernels
    of one device, so here each of the rank's cards replays its own graph.

    Within the rank the cards meet at ``CardLoop``'s three sync points through
    ``kernels/mesh_sync.py``, with the rank link in the home card's graph:

      - rows: a row or column whose neighbour is local goes straight into its halo, as in
        ``CardLoop``; one whose neighbour lives on another rank goes into its piece's send
        buffer on the home card (``staging``, one a ``_RankLink`` piece) with a flag
        there (``send_flags``).  Between its shards' publishes and their waits the home
        card waits for every send flag, runs the exchange (``batch_isend_irecv`` of the
        send buffers into the receive buffers, ``work.wait()`` the join), then publishes
        what arrived into each piece's halo with the shard's row flag, on whatever card
        the shard sits;
      - a dot: each shard publishes its partial into its slot of the home card's gather
        buffer (``gather``, flags ``gather_flags``); the home card waits for all of them,
        all-gathers them over NCCL (``all_gather_into_tensor``) and adds the N partials in
        global shard order (``sum_in_shard_order``: ``_allsum``'s order and dtype, so the
        bits of the eager NCCL ranks, the gloo ranks and ``_mesh_sum``), then publishes the
        total into every shard's one slot with its flag; each shard waits for it and forms
        α or β itself, as in ``CardLoop``.

    Epochs: the home card's waits for its rank's shards advance an epoch of their own
    (``lctl``, the link's; error word ``lctl[1]``), one wait at every sync point, so it
    rises as every shard's does.  The home card's publishes (rows that arrived, the
    totals) come after its shards' publishes and before their waits in its stream
    (``_between``), so they take the epoch from the ctl of the home card's first live
    shard, which has not yet advanced past the sync point.  ``CardLoop``'s argument that
    no write lands before its reader is done with the last one holds for the new buffers
    too (k the iteration; the home card's stream is one order):

      - a piece's send buffer: its shard writes it at the rows point of k + 1, after its
        wait at <r, r> of k, which needs the home card's total of k, published after that
        sum's all-gather, which follows the exchange of k in the home card's stream, after
        ``work.wait()`` (the send is done);
      - a piece's receive buffer: the exchange of k + 1 writes it, after the home card's
        publish of k read it, in the home card's stream;
      - a halo that the rank link fills: the home card publishes into it at the rows
        point of k + 1, after its wait for every shard's <r, r> partial of k, which the
        shard publishes after its last read of its halos in k;
      - a gather slot of shard s: s writes it at a dot point after its wait at the
        previous dot point for that point's total, which the home card published after
        that point's all-gather had read the slots;
      - a shard's total slot: the home card writes it at a dot point of k + 1 after its
        wait for every shard's partial of that point, which shard s publishes after its
        wait at the same point of k read the slot;
      - the all-gather's buffer and the total: the home card's stream alone.

    Bounds: a shard's wait depends on the other ranks (their rows and partials come
    through NCCL), so it is bounded by the rank's stall bound (``RANK_WAIT_BOUND_S``);
    the home card's waits depend only on its rank's cards (``WAIT_BOUND_S``).  The ranks
    meet at a barrier after a capture and before its first replay, so no wait counts a
    peer's capture.  A home card's wait that passed its bound sets the link's error word,
    and its next gather is NaN on every slot, so every rank's sums turn NaN and every
    card of every rank stops; a rank whose sum came back NaN raises.  The host watches
    the replays as ``MeshLoop._replay`` does: where no iteration ends for ``bound_s`` (a
    peer that never came to a captured call) it aborts the NCCL group and raises.

    One replay a card and one read a rank a solve.  On the CPU (gloo ranks, the tests)
    the rank's model cards (``card_of``) run ``CardLoop``'s coroutines, interleaved, and
    the home card's program makes the link's gloo calls where the card makes NCCL's
    (``group``, the link's group; a test may give another, of a short timeout).
    ``rank_withheld``: the rank replays nothing (runs no program), to test the bound."""

    def __init__(self, op, loop, max_iters, tolerance, unroll=cg.UNROLL):
        self.group = op.link.group
        self.rank_withheld = False
        super().__init__(op, loop, max_iters, tolerance, unroll)
        self.bound_s = RANK_WAIT_BOUND_S
        self.bound_ns = int(RANK_WAIT_BOUND_S * 1e9)  # a shard's: it waits for the ranks
        self.link_bound_ns = int(WAIT_BOUND_S * 1e9)  # the home card's: the rank's cards
        if self.graphed:
            # where the host reads k while the replays run (MeshLoop._k_now)
            self.watch = torch.cuda.Stream(self.device)
            self.k_seen = torch.full((), -1, dtype=torch.int64, pin_memory=True)

    def _dot_slots(self) -> int:
        return 1  # the total, which the home card publishes

    def _make_links(self):
        """The rank link's buffers on the home card, then ``CardLoop``'s links (a
        neighbour on another rank: its piece's send buffer; a dot's partial: its slot of
        the home card's gather buffer)."""
        home, link, n = self.device, self.link, len(self.parts)
        acc = self.parts[0].rr.dtype
        self.lctl = torch.zeros(2, dtype=torch.int64, device=home)
        self.staging = {(p.k, p.side): tuple(torch.empty(p.halo.numel(), dtype=self.dtype,
                                                         device=home) for _ in range(2))
                        for p in link.pieces}
        self.send_flags = torch.zeros(max(len(link.pieces), 1), dtype=torch.int64,
                                      device=home)
        self.send_flag = {(p.k, p.side): self.send_flags[j]
                          for j, p in enumerate(link.pieces)}
        self.gather = torch.zeros((2, n), dtype=acc, device=home)
        self.gather_flags = torch.zeros((2, n), dtype=torch.int64, device=home)
        self.every = torch.empty(dist.world_size() * n, dtype=acc, device=home)
        self.total = torch.empty((), dtype=acc, device=home)
        self.ok = torch.empty((), dtype=torch.bool, device=home)
        self.nan = torch.full((), float("nan"), dtype=acc, device=home)
        self.arrived = mesh_sync.row_links(
            [(self.staging[(p.k, p.side)][1], p.halo.view(-1),
              self.parts[p.k].row_flags[p.side]) for p in link.recvs], home) \
            if link.pieces else None
        self.totals = tuple(mesh_sync.partial_links(
            [(t.partials[d, 0], t.dot_flags[d][0]) for t in self.parts], home)
            for d in (0, 1))
        super()._make_links()

    def _dot_items(self, i, d):
        return [(self.gather[d, i], self.gather_flags[d, i])]

    def _outbound(self, i, side):
        return self.staging[(i, side)][0], self.send_flag[(i, side)]

    def cards(self):
        """``CardLoop``'s cards; the home card (its first shard's) holds NCCL's calls, so
        each of its iterations sits under an IF node of its own (``MeshLoop``'s
        ``guard_first``), and every card captures ``thread_local`` (NCCL's watchdog
        thread may query events meanwhile)."""
        cards = super().cards()
        for card in cards:
            card.guard_first = self._home(card.members)
            if self.group is not None:
                card.capture_mode = "thread_local"
        return cards

    def _home(self, members) -> bool:
        return self.card_of[members[0].index] == self.card_of[0]

    def _lead(self):
        """The home card's first live shard."""
        return next(s for s in self.parts
                    if s.index != self.withheld and self._home([s]))

    # -- the home card's link -------------------------------------------------------------

    def _between(self, members, point):
        if not self._home(members):
            return
        points = ("rows", 0, 1) if self.exchanging else (0, 1)
        point = points[point]
        if point == "rows":
            yield functools.partial(self._link_wait, self.send_flags,
                                    (1 << len(self.link.pieces)) - 1, 1)
            yield self._link_rows
        else:
            yield functools.partial(self._link_wait, self.gather_flags[point],
                                    (1 << len(self.parts)) - 1, 2 + point)
            yield functools.partial(self._link_sum, point)

    def _link_wait(self, flags, mask, point, bound_ns):
        """The home card's wait for its rank's shards at a sync point: the link's own
        epoch, the rank's cards' bound (0: the bound has passed, on the CPU)."""
        return mesh_sync.wait(self.lctl, flags, mask, point, min(bound_ns, self.link_bound_ns))

    def _link_rows(self, bound_ns):
        """The rows sync point's exchange between the ranks, then what arrived published
        into the halos, each with its shard's row flag."""
        del bound_ns
        link = self.link
        if not link.pieces:
            return True
        ops = [tdist.P2POp(tdist.isend, self.staging[(p.k, p.side)][0], p.peer, self.group,
                           p.send_tag) for p in link.sends]
        ops += [tdist.P2POp(tdist.irecv, self.staging[(p.k, p.side)][1], p.peer, self.group,
                            p.recv_tag) for p in link.recvs]
        with _current(self.device):
            for work in tdist.batch_isend_irecv(ops):  # the stream waits for NCCL's
                work.wait()
        return mesh_sync.publish_rows(self._lead().ctl, self.arrived)

    def _link_sum(self, d, bound_ns):
        """Dot ``d``'s partials of every rank, all-gathered and added in global shard order
        (NaN on every slot if a wait of this card gave up), published to every shard."""
        del bound_ns
        slots = self.gather[d]
        torch.eq(self.lctl[1], 0, out=self.ok)
        torch.where(self.ok, slots, self.nan, out=slots)
        with _current(self.device):
            tdist.all_gather_into_tensor(self.every, slots, group=self.group)
        sum_in_shard_order(self.every, out=self.total)
        return mesh_sync.publish_partial(self._lead().ctl, self.total, self.totals[d])

    # -- the solve ------------------------------------------------------------------------

    def _slot(self):
        slots = self.solutions.setdefault(self.withheld, [])
        made = len(slots)
        slot = super()._slot()
        if self.graphed and len(slots) > made:
            dist.barrier()  # every rank's capture done before any replays
        return slot

    def _run_host(self, xs):
        if self.rank_withheld:
            return
        try:
            super()._run_host(xs)
        except RuntimeError as e:  # a peer's gloo call that never came, past its timeout
            raise RuntimeError(f"rank {dist.rank()}: the sharded CG's {self.loop} solve "
                               f"stopped in a call between the ranks ({e}): a rank never "
                               "came to its exchanges and sums") from e

    def _replay(self, graphs):
        """Every card's graph replayed (none: ``rank_withheld``), then the host waits for
        them as long as the home card finishes an iteration at least once every
        ``bound_s``; a stall aborts the NCCL group and raises (``MeshLoop._replay``)."""
        if not self.rank_withheld:
            super()._replay(graphs)
        ends = []
        for card in self.cards():
            with torch.cuda.device(card.device):
                ends.append(torch.cuda.Event())
                ends[-1].record()
        if not _watch(lambda: all(e.query() for e in ends), self._k_now, self.bound_s):
            if self.group is not None:
                dist.abort_nccl(self.group)
            raise RuntimeError(
                f"rank {dist.rank()}: the sharded CG's {self.loop} solve, replayed from a "
                f"graph a card, finished no iteration for its bound of {self.bound_s:g} s "
                f"(k stayed {int(self.k_seen)}): a rank never came to its exchanges and sums "
                "(NCCL's communicator is aborted)")

    def _k_now(self):
        """``MeshLoop._k_now`` on the home card's first live shard's k."""
        if not self.watch.query():
            return None
        k = int(self.k_seen)
        with torch.cuda.stream(self.watch):
            self.k_seen.copy_(self._lead().k, non_blocking=True)
        return k

    def _read(self, graphs):
        k, rr, bb = super()._read(graphs)
        if rr != rr:
            raise RuntimeError(f"rank {dist.rank()}: the sharded CG's sums came back NaN "
                               f"after {k} iterations: a wait on another rank passed its "
                               "bound, and its rank's gather carried NaN")
        return k, rr, bb

    def _error_words(self):
        return (self.lctl[1],)

    def _waiter(self, code) -> str:
        return "the home card" if code < 16 else super()._waiter(code)


def _publish(fn, args, bound_ns):
    """A publish as a sync op of ``CardLoop._steps``: it goes through at once."""
    del bound_ns
    return fn(*args)


def _code(s, point):
    """The error word of shard ``s``'s wait at sync point ``point`` (``SYNC_POINTS``)."""
    return 16 * (s.index + 1) + point


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def _pick_loop(op, recompute_ap) -> str:
    """"recompute" or "classic" for ``recompute_ap`` (None: the recompute loop on
    ``stencil5-const`` row bands, as the JAX package; True requires it), checked against
    the state's dtype (``cg.check_loop``)."""
    bands_const = op.mode == "stencil5-const" and op.mesh_shape is None
    recompute = bands_const if recompute_ap is None else bool(recompute_ap)
    if recompute and not bands_const:
        raise ValueError("recompute_ap: only mode='stencil5-const' on row bands provides "
                         "the recompute passes in the sharded solver")
    loop = "recompute" if recompute else "classic"
    check_loop(op.dtype, loop)
    return loop


def _cg_stats(k, rr, rr0, tolerance, max_iters, t0) -> CGStats:
    """The ``CGStats`` of a solve that took k iterations from <r0, r0> = rr0 to rr,
    started at ``t0`` (``time.perf_counter``)."""
    res, b_norm = float(rr) ** 0.5, float(rr0) ** 0.5
    return CGStats(
        iterations=k,
        converged=cg.converged(res, b_norm, tolerance, k, max_iters),
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=(time.perf_counter() - t0) * 1e3,
    )


def cg_solve_sharded(grid_size: int, *, b=None, mode: str = "stencil5-const", planes=None,
                     matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                     tolerance: float = 1e-6, max_iters: int = 1000, dtype=torch.float32,
                     overlap: bool = True, config: Optional[CGConfig] = None,
                     use_pallas_blas1: Optional[bool] = None, operator=None,
                     recompute_ap: Optional[bool] = None, device="cuda",
                     mesh: Optional[dist.Mesh] = None, graph: Optional[bool] = None,
                     per_shard: bool = False):
    """Sharded CG solve over a mesh in this process (``mesh``, or a ``MeshOperator`` as
    ``operator``), or on this gloo rank's band, every rank of the group calling it.

    Over a mesh it returns (x, CGStats) with x the global (g, g) field on the mesh's first
    device, as the JAX package returns it (``MeshOperator.solve`` gives the shards' fields
    instead); ``graph`` and ``per_shard`` as in ``MeshOperator.solve``.  On a rank x is
    this rank's band, (band, g) on its device, pad rows included;
    ``dist.gather_to_host(x, rows=g)`` gives rank 0 the field.  Ranks over NCCL (each a
    card of its own) run the loop from one CUDA graph a rank (``rank_mesh``; ``graph``
    None or True; a mesh across ranks whose rank drives several cards, one graph a card),
    or eagerly with ``graph=False``; ranks over gloo eagerly (``graph=True`` raises
    ValueError there); ``per_shard=True`` raises on a rank.

    ``b``: None builds each shard's band of b = ones; else the whole (g, g) field, of which
    each shard takes its rows.  ``recompute_ap``: None runs the recompute loop (K1, K2)
    when the operator is ``stencil5-const`` on row bands, as the JAX package does; True
    requires it.  A bf16 state runs the classic loop only (``cg.check_loop``: ValueError
    where the recompute loop would run; ``recompute_ap=False`` runs ``stencil5-const``
    classic).  ``use_pallas_blas1``: True or None runs K4-K6, False plain PyTorch ops.  The
    convergence test and the ``CGStats`` fields are those of ``cg.cg_solve``: iterations
    while rr > tol²·<b, b>.  ``operator``: a prebuilt operator (the CLI's), else one is
    made (``make_mesh_operator`` or ``make_sharded_operator``)."""
    if config is not None:
        tolerance, max_iters = config.tolerance, config.max_iters
    kw = dict(mode=mode, planes=planes, matrix=matrix, diag=diag, offdiag=offdiag,
              dtype=dtype, overlap=overlap)
    op = operator if operator is not None else (
        make_mesh_operator(grid_size, mesh, **kw) if mesh is not None
        else make_sharded_operator(grid_size, device=device, **kw))
    if isinstance(op, MeshOperator):
        xs, stats = op.solve(b, tolerance=tolerance, max_iters=max_iters,
                             recompute_ap=recompute_ap, use_pallas_blas1=use_pallas_blas1,
                             graph=graph, per_shard=per_shard)
        return op.assemble(xs), stats
    nccl = op.halo.group is not None
    if per_shard:
        raise ValueError("per_shard=True: a rank of one shard runs its loop eagerly or, over "
                         "NCCL, from one graph; the per-card loop is one process's: pass a "
                         "mesh")
    if graph and not nccl:
        raise ValueError("graph=True: ranks over gloo run the eager loop: the host steps it, "
                         "halos and dots pass through it; a graph a rank needs NCCL between "
                         "ranks that each have one card of their own")
    if nccl and graph is not False:  # the rank mesh of one shard a rank, one graph a rank
        xs, stats = rank_mesh(op).solve(b, tolerance=tolerance, max_iters=max_iters,
                                        recompute_ap=recompute_ap,
                                        use_pallas_blas1=use_pallas_blas1, graph=graph)
        return xs[0], stats
    recompute = _pick_loop(op, recompute_ap) == "recompute"
    kernels = use_pallas_blas1 is not False
    dot = blas1.dot if kernels else blas1.dot_plain

    t0 = time.perf_counter()
    with cg.solve_scope():
        with profiling.scope(profiling.PHASE_START):
            r = op.ones_b() if b is None else op.band_of(b)  # x0 = 0: r0 = b
            x = torch.zeros_like(r)
            group = op.halo.group
            rr = rr0 = _allsum(dot(r, r), group=group)
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
                    x, r, rr_local = cg_update(_on(rr / pap, op.device, op.dtype), x, r, p,
                                               ap)
                del ap
                rr_new = _allsum(rr_local, group=group)
                with profiling.scope(profiling.PHASE_UPDATE_P):
                    p_update(_on(rr_new / rr, op.device, op.dtype), r, p)  # p = r + β·p
                rr = rr_new
                k += 1
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    return x, _cg_stats(k, rr, rr0, tolerance, max_iters, t0)


def rank_mesh(op) -> MeshOperator:
    """A rank's one shard (``make_sharded_operator`` with ``shard`` None: a band or a block
    of the group's ranks) as a mesh across the ranks of one shard a rank, its operator
    shared (no operand is made again): the ``MeshOperator`` whose ``MeshLoop`` runs it
    from one graph a rank over NCCL, or on the CPU the graph's structure (the tests).  Its
    link (``_RankLink``) passes the shard's rows and columns to the neighbours' ranks,
    rank = shard, into the buffers of the shard's halo.  Made once an operator and kept
    with the cached operators (``clear_caches``); collective the first time: every rank
    calls it."""
    key = ("rank mesh", id(op))
    if key not in _OPERATOR_CACHE:
        shape = op.mesh_shape or (dist.world_size(),)
        mesh = dist.Mesh(shape, ("x", "y")[:len(shape)], (op.device,) * int(np.prod(shape)),
                         dist.world_size(), dist.rank())
        transport = "gloo" if op.halo.group is None else "nccl"
        _OPERATOR_CACHE[key] = MeshOperator(mesh, (op,),
                                            _RankLink((op,), dist.rank(), transport))
    return _OPERATOR_CACHE[key]


def _recompute_loop(op, x, r, rr, tol2, max_iters):
    """The recompute-Ap iteration on a gloo rank: p′'s boundary rows r + β·p are formed
    on the device (``ShardedOperator.edge_rows``) and exchanged once, then K1 forms p′ and
    <p′, A·p′> and K2 x′, r′ and <r′, r′>, both over the same halo rows.  The halo volume
    is the classic loop's: one row per neighbour per iteration."""
    p_prev = torch.zeros_like(r)
    p_buf = torch.empty_like(r)
    rr_prev = torch.ones_like(rr)
    kw = {"diag": op.diag, "offdiag": op.offdiag}
    k = 0
    while k < max_iters and bool(rr > tol2):
        beta = _on(0.0 if k == 0 else rr / rr_prev, op.device, op.dtype)
        if op.halo.has_rows:
            rows = op.edge_rows(r, p_prev, beta)
            op.halo.start(rows[0], rows[-1])
        hp, hn, _, _ = op.halo.finish()
        with profiling.scope(profiling.PHASE_SPMV):
            p, pap_local = _st5.spmv_stencil5_const_pupdate_dot(beta, r, p_prev, hp, hn,
                                                                out=p_buf, **kw)
        op.halo.count("spmv_stencil5_const_pupdate_dot", hp, hn)
        pap = _allsum(pap_local, group=op.halo.group)
        with profiling.scope(profiling.PHASE_AXPY):
            x, r, rr_local = _st5.cg_const_update_recompute(
                _on(rr / pap, op.device, op.dtype), x, r, p, hp, hn, **kw)
        op.halo.count("cg_const_update_recompute", hp, hn)
        rr_new = _allsum(rr_local, group=op.halo.group)
        p_buf, p_prev = p_prev, p
        rr_prev, rr = rr, rr_new
        k += 1
    return x, r, rr, k


class _OneRank:
    """The stepped loop's transport on a rank of one shard (``MeshOperator`` is the
    mesh's): its halos exchanged by its ``_HaloExchange``, its sums gathered by
    ``_allsum`` over the same transport."""

    def __init__(self, op):
        self.shards = (op,)

    def exchange(self, fields):
        self.shards[0].halo.exchange(fields[0])

    def sum(self, parts):
        return _allsum(*parts, group=self.shards[0].halo.group)

    def sync(self):
        if self.shards[0].device.type == "cuda":
            torch.cuda.synchronize(self.shards[0].device)


def cg_solve_sharded_stepped(grid_size: int, *, b=None, mode: str = "stencil5",
                             planes=None, matrix=None, diag: float = 5.0,
                             offdiag: float = -1.0, tolerance: float = 1e-6,
                             max_iters: int = 1000, dtype=torch.float32, overlap: bool = True,
                             verbose: int = 0, operator=None, device="cuda",
                             mesh: Optional[dist.Mesh] = None):
    """Host-stepped sharded classic CG with wall time per phase: the multichip CLI's
    ``--timers`` loop, with the reference's CGStatsMultiGPU buckets
    (cg_solver_mgpu.h:55-67).  Every phase ends in ``torch.cuda.synchronize()`` on a card
    (every card of a mesh):

      halo_time_ms      — the halo exchange: a mesh's device copies (across ranks also
                          the link's messages); a rank's NCCL exchange, or over gloo its
                          boundary rows' (on a 2-D mesh also side columns') D2H copy,
                          their gloo exchange and the H2D copy of the halos (the
                          reference's staged MPI_Isend/Irecv);
      spmv_time_ms      — every shard's SpMV with the halos provided (on a 2-D mesh with
                          its side columns' corrections): compute only;
      allreduce_time_ms — <r0, r0> and <p, A·p> through K6, and each dot's sum in shard
                          order and read to the host (<r, r> comes from K4, so its local
                          pass is in blas1); mirrored into reduction_time_ms for the
                          single-device field parity;
      blas1_time_ms     — K4 (x, r and the local <r, r>) and K5 (p).

    α and β are formed on the host in double precision.  The JAX package's dispatch
    correction, a relay correction, has no counterpart.  Returns (x, CGStats) as
    ``cg_solve_sharded``: over a mesh (``mesh`` or a ``MeshOperator`` as ``operator``) the
    global field (a mesh across ranks: ``MeshOperator.assemble``), on a rank its band."""
    kw = dict(mode=mode, planes=planes, matrix=matrix, diag=diag, offdiag=offdiag,
              dtype=dtype, overlap=overlap)
    op = operator if operator is not None else (
        make_mesh_operator(grid_size, mesh, **kw) if mesh is not None
        else make_sharded_operator(grid_size, device=device, **kw))
    if isinstance(op, MeshOperator):
        xs, stats = op.solve_stepped(b, tolerance=tolerance, max_iters=max_iters,
                                     verbose=verbose)
        return op.assemble(xs), stats
    (x,), stats = _stepped(_OneRank(op), b, tolerance, max_iters, verbose)
    return x, stats


def _stepped(t, b, tolerance, max_iters, verbose):
    """The stepped loop over transport ``t`` (a ``MeshOperator`` or a ``_OneRank``):
    (the shards' x fields, CGStats)."""
    shards = t.shards
    stats = CGStats()
    t_solve = time.perf_counter()
    r = [sh.ones_b() if b is None else sh.band_of(b) for sh in shards]
    x = [torch.zeros_like(f) for f in r]
    p = [sh.p_buffer() for sh in shards]
    for pi, ri in zip(p, r):
        pi.copy_(ri)
    t0 = time.perf_counter()
    rr = float(t.sum([blas1.dot(ri, ri) for ri in r]))
    stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
    b_norm = rr ** 0.5
    k = 0
    converged = rr == 0.0  # a zero right-hand side: x = 0, no iteration
    while k < max_iters and not converged:
        t0 = time.perf_counter()
        t.exchange(p)
        t.sync()
        t1 = time.perf_counter()
        with profiling.scope(profiling.PHASE_SPMV):
            ap = [sh.local_spmv(p[i], *sh.halo.halos()) for i, sh in _by_shard(shards)]
            t.sync()
        t2 = time.perf_counter()
        pap = float(t.sum([blas1.dot(p[i], ap[i]) for i, _ in _by_shard(shards)]))
        t3 = time.perf_counter()
        with profiling.scope(profiling.PHASE_AXPY):
            rrs = [blas1.cg_update(rr / pap, x[i], r[i], p[i], ap[i])[2]
                   for i, _ in _by_shard(shards)]
            t.sync()
        t4 = time.perf_counter()
        rr_new = float(t.sum(rrs))
        t5 = time.perf_counter()
        del ap
        stats.halo_time_ms += (t1 - t0) * 1e3
        stats.spmv_time_ms += (t2 - t1) * 1e3
        stats.allreduce_time_ms += ((t3 - t2) + (t5 - t4)) * 1e3
        stats.blas1_time_ms += (t4 - t3) * 1e3
        k += 1
        if verbose >= 2 and dist.rank() == 0:
            print(f"[CG-SHARDED] Iter {k:3d}: rel = {rr_new ** 0.5 / b_norm:e}")
        if rr_new == 0 or rr_new ** 0.5 < tolerance * b_norm:
            converged = True
        else:
            t0 = time.perf_counter()
            with profiling.scope(profiling.PHASE_UPDATE_P):
                for i, _ in _by_shard(shards):
                    blas1.p_update(rr_new / rr, r[i], p[i])
                t.sync()
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        rr = rr_new
    stats.reduction_time_ms = stats.allreduce_time_ms
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged or cg.converged(rr ** 0.5, b_norm, tolerance, k, max_iters)
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm else 0.0
    return tuple(x), stats


def _block_operator(mesh, grid_size, operator, device, **kw):
    """``operator`` (which must be a block of this mesh), else the blocks made for it: on
    a ``dist.Mesh`` of two axes a ``MeshOperator``, on an (R, C) mesh of gloo ranks this
    rank's block."""
    if isinstance(mesh, dist.Mesh):
        if len(mesh.shape) != 2:
            raise ValueError(f"2-D solver needs a 2-axis mesh (R, C), got shape {mesh.shape}")
        if operator is None:
            return make_mesh_operator(grid_size, mesh, **kw)
        if not isinstance(operator, MeshOperator) or operator.mesh != mesh \
                or operator.grid_size != grid_size:
            raise ValueError(f"operator is not {grid_size}² on the mesh {mesh.shape}")
        return operator
    if operator is None:
        return make_sharded_operator(grid_size, mesh_shape=mesh, device=device, **kw)
    want = _check_2d_mesh(mesh, grid_size, operator.mode, dist.world_size())
    if operator.mesh_shape != want or operator.grid_size != grid_size:
        raise ValueError(f"operator is not a block of {grid_size}² on a "
                         f"{want[0]}x{want[1]} mesh")
    return operator


def cg_solve_sharded_2d(mesh, grid_size: int, *, mode: str = "stencil5", planes=None,
                        diag: float = 5.0, offdiag: float = -1.0, tolerance: float = 1e-6,
                        max_iters: int = 1000, dtype=torch.float32, b=None,
                        overlap: bool = True, use_pallas_blas1: Optional[bool] = None,
                        operator=None, device="cuda", graph: Optional[bool] = None,
                        per_shard: bool = False):
    """CG over the 2-D block decomposition (the JAX package's ``cg_solve_sharded_2d``,
    ``cg_sharded.py:828-878``): ``mesh`` a ``dist.Mesh`` of two axes (R, C) that this
    process drives, or an (R, C) shape of the group's gloo ranks, every rank calling it.
    The classic loop, each iteration the block's SpMV with its dot after the exchange of
    rows and columns (overlapped when ``overlap`` and blocks of 3 rows or more), K4, the
    sum of <r, r> in shard order, then K5 (``use_pallas_blas1=False``: plain PyTorch
    updates).  ``b``: None builds each block of b = ones; else the whole (g, g) field.
    ``planes``: a whole (5, g, g) host array (a file's), else synthesized.  The grid must
    divide by R and C (ValueError; ``cg_solve_sharded`` pads instead).  Returns (x,
    CGStats): over a mesh the global field (``graph`` and ``per_shard`` as in
    ``MeshOperator.solve``), over a mesh across ranks (``dist.make_rank_mesh((R, C))``)
    the rank's blocks, on a rank of an R·C group its (g/R, g/C) block;
    ``dist.gather_blocks_to_host(x, (R, C))`` gives rank 0 the field."""
    op = _block_operator(mesh, grid_size, operator, device, mode=mode, planes=planes,
                         diag=diag, offdiag=offdiag, dtype=dtype, overlap=overlap)
    return cg_solve_sharded(grid_size, b=b, tolerance=tolerance, max_iters=max_iters,
                            use_pallas_blas1=use_pallas_blas1, operator=op,
                            recompute_ap=False, graph=graph, per_shard=per_shard)


def cg_solve_sharded_2d_stepped(mesh, grid_size: int, *, mode: str = "stencil5",
                                planes=None, diag: float = 5.0, offdiag: float = -1.0,
                                tolerance: float = 1e-6, max_iters: int = 1000,
                                dtype=torch.float32, b=None, overlap: bool = True,
                                verbose: int = 0, operator=None, device="cuda"):
    """The host-stepped 2-D CG with wall time per phase: the multichip CLI's ``--timers``
    loop on a 2-D mesh (the JAX package's ``cg_solve_sharded_2d_stepped``,
    ``cg_sharded.py:881-995``), the buckets of ``cg_solve_sharded_stepped``, its ``halo``
    bucket timing the exchange of all four neighbours' rows and columns.  No dispatch
    correction, as on row bands.  ``mesh`` and the return as ``cg_solve_sharded_2d``."""
    op = _block_operator(mesh, grid_size, operator, device, mode=mode, planes=planes,
                         diag=diag, offdiag=offdiag, dtype=dtype, overlap=overlap)
    return cg_solve_sharded_stepped(grid_size, b=b, tolerance=tolerance,
                                    max_iters=max_iters, verbose=verbose, operator=op)

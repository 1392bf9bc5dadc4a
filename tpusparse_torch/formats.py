"""Host-side sparse matrix containers of the port, and the conversions between them.

The port's own copy of ``tpusparse/formats.py``, trimmed to what the port uses; the tests
hold each conversion against the original on the same numpy inputs.  Containers hold
numpy arrays with int64 indices (the reference's ``int nnz`` overflows past ~21.5k grids):

  - ``COOMatrix``  the reference's ``MatrixData`` (include/io.h:53-59);
  - ``CSRMatrix``  rows sorted by column (reference build_csr_struct,
                   spmv_cusparse_csr.cu:62-170);
  - ``ELLMatrix``  rows padded to one width (reference include/spmv_ellpack.h:28-36): the
                   host pack that ``convert.ell_from_numpy`` carries to the ELL kernel;
  - ``DIAMatrix``  diagonal-offset storage, ``A[i, i + offsets[d]] = data[d, i]``: the host
                   pack of the DIA kernel;
  - ``Stencil5``   the 5-point stencil on a g×g grid as five (g, g) coefficient planes in
                   the order N, W, C, E, S, or planes-free with constant coefficients;
  - ``Stencil27``  HPCG's 27-point stencil on an nx×ny×nz grid, constant coefficients
                   (``stencil27_to_csr`` writes its rows on the host).

The device operands are made from these by ``convert`` and ``generate``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Stencil coefficient plane order (the reference's sorted-CSR invariant [N, W, C, E, S] for
# interior rows, spmv_stencil_csr_direct.cu:105-109).
N, W, C, E, S = 0, 1, 2, 3, 4
STENCIL_PLANE_NAMES = ("N", "W", "C", "E", "S")


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format host matrix (reference ``MatrixData``, include/io.h:53-59)."""

    num_rows: int
    num_cols: int
    row: np.ndarray  # int64 (nnz,)
    col: np.ndarray  # int64 (nnz,)
    val: np.ndarray  # float64 (nnz,)
    grid_size: int = 0  # >0 iff the matrix came from a STENCIL_GRID_SIZE header

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def validate(self) -> None:
        if not (self.row.shape == self.col.shape == self.val.shape):
            raise ValueError("COO arrays must have identical shapes")
        if self.nnz and (self.row.min() < 0 or self.row.max() >= self.num_rows):
            raise ValueError("COO row index out of range")
        if self.nnz and (self.col.min() < 0 or self.col.max() >= self.num_cols):
            raise ValueError("COO col index out of range")


@dataclasses.dataclass
class CSRMatrix:
    """CSR host matrix with each row sorted by column index: the CSR-to-Stencil5 extraction
    relies on interior rows stored as [N, W, C, E, S], as the reference's STENCIL5 kernel
    does (spmv_stencil_csr_direct.cu:105-109)."""

    num_rows: int
    num_cols: int
    row_ptr: np.ndarray  # int64 (num_rows+1,)
    col_idx: np.ndarray  # int64 (nnz,)
    val: np.ndarray  # float64 (nnz,)
    grid_size: int = 0

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def max_row_nnz(self) -> int:
        if self.num_rows == 0:
            return 0
        return int(np.max(np.diff(self.row_ptr)))

    def to_dense(self) -> np.ndarray:
        """Dense materialization: the correctness oracle for small matrices."""
        dense = np.zeros((self.num_rows, self.num_cols), dtype=self.val.dtype)
        for i in range(self.num_rows):
            lo, hi = self.row_ptr[i], self.row_ptr[i + 1]
            # duplicate columns add up, as in SpMV
            np.add.at(dense[i], self.col_idx[lo:hi], self.val[lo:hi])
        return dense


@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK: rows padded to one width.  Pad slots carry ``val = 0`` and an in-range
    column (the row's last real column), so an SpMV needs no masking."""

    num_rows: int
    num_cols: int
    width: int
    col: np.ndarray  # int64 (num_rows, width)
    val: np.ndarray  # float64 (num_rows, width)
    grid_size: int = 0

    @property
    def nnz_padded(self) -> int:
        return int(self.col.size)


@dataclasses.dataclass
class DIAMatrix:
    """Diagonal-offset storage: ``A[i, i + offsets[d]] = data[d, i]``, zero where the
    diagonal leaves the matrix; SpMV is ``y[i] = Σ_d data[d, i] · x[i + off_d]``."""

    num_rows: int
    num_cols: int
    offsets: np.ndarray  # int64 (ndiag,), sorted
    data: np.ndarray  # float64 (ndiag, num_rows)
    grid_size: int = 0

    @property
    def ndiag(self) -> int:
        return int(self.offsets.shape[0])


@dataclasses.dataclass
class Stencil5:
    """Values-only 5-point stencil operand over a g×g grid.

    ``planes`` has shape (5, g, g) ordered [N, W, C, E, S]; plane p at grid point (i, j) is
    the coefficient of x at (i-1, j) / (i, j-1) / (i, j) / (i, j+1) / (i+1, j).  Off-grid
    neighbours have coefficient 0 (the Dirichlet boundary: the reference's boundary rows
    have fewer CSR entries, io.cu:375-391).  ``constant`` records (diag, offdiag) when every
    interior point shares them; ``planes=None`` with ``constant`` set is the planes-free
    form of ``gen:<g>``, whose operands are made on the device."""

    grid_size: int
    planes: Optional[np.ndarray]  # float64 (5, g, g), or None
    constant: Optional[tuple] = None  # (diag, offdiag) if uniform

    @property
    def num_rows(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def nnz(self) -> int:
        g = self.grid_size
        # diag everywhere + 4 neighbours minus the ones clipped at each of the 4 edges
        return 5 * g * g - 4 * g


# HPCG's 27 neighbour offsets (sz, sy, sx), in the order its generator loops over them
# (src/GenerateProblem_ref.cpp: sz, then sy, then sx, each −1, 0, 1); slot 13 is the point
# itself.  Each row's columns come out ascending in this order.
STENCIL27_OFFSETS = tuple((sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1)
                          for sx in (-1, 0, 1))
STENCIL27_CENTER = 13


@dataclasses.dataclass
class Stencil27:
    """HPCG's problem (https://github.com/hpcg-benchmark/hpcg, src/GenerateProblem_ref.cpp):
    the 27-point stencil on an nx×ny×nz grid, row ``iz·nx·ny + iy·nx + ix`` for point
    (ix, iy, iz), coupling the point to each neighbour that lies on the grid (Dirichlet
    edges: boundary rows hold 8, 12 or 18 entries, interior rows 27), with the coefficient
    ``constant[0]`` on the diagonal and ``constant[1]`` off it (HPCG's 26 and −1).  Planes
    free: its operands are made on the device (``generate.make_stencil27_ell_device``)."""

    nx: int
    ny: int
    nz: int
    constant: tuple = (26.0, -1.0)  # (diag, offdiag)

    @property
    def num_rows(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def nnz(self) -> int:
        # along each axis a point has 3 neighbours in the grid, 2 at either edge
        return (3 * self.nx - 2) * (3 * self.ny - 2) * (3 * self.nz - 2)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """COO -> CSR with each row sorted by column (reference build_csr_struct,
    spmv_cusparse_csr.cu:62-170).  The native builder (``native.coo_to_csr_sorted``) when
    its library is available, else one stable lexsort by (row, col)."""
    coo.validate()
    from . import native

    if native.available() and coo.nnz:
        row_ptr, col_idx, val = native.coo_to_csr_sorted(coo.num_rows, coo.row, coo.col,
                                                         coo.val)
        return CSRMatrix(num_rows=coo.num_rows, num_cols=coo.num_cols, row_ptr=row_ptr,
                         col_idx=col_idx, val=val, grid_size=coo.grid_size)
    order = np.lexsort((coo.col, coo.row))
    row = coo.row[order]
    counts = np.bincount(row, minlength=coo.num_rows).astype(np.int64)
    row_ptr = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRMatrix(num_rows=coo.num_rows, num_cols=coo.num_cols, row_ptr=row_ptr,
                     col_idx=coo.col[order].astype(np.int64),
                     val=coo.val[order].astype(np.float64), grid_size=coo.grid_size)


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    """CSR -> COO in row order; the index and value arrays are copies, never views of the
    CSR's."""
    row = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    return COOMatrix(num_rows=csr.num_rows, num_cols=csr.num_cols, row=row,
                     col=csr.col_idx.copy(), val=csr.val.copy(), grid_size=csr.grid_size)


def _pad_with_last_column(col, row_lens, w):
    """Pad slots repeat the row's last real column (val stays 0); an empty row keeps
    col = row.  Any in-range column is right with a zero value; this one keeps a short
    row's pad next to its neighbours' columns."""
    n = col.shape[0]
    last = np.where(row_lens > 0, col[np.arange(n), np.maximum(row_lens - 1, 0)],
                    np.arange(n, dtype=np.int64))
    pad_mask = np.arange(w)[None, :] >= row_lens[:, None]
    return np.where(pad_mask, last[:, None], col)


def csr_to_ell(csr: CSRMatrix, width: Optional[int] = None) -> ELLMatrix:
    """CSR -> ELLPACK (the conversion the reference declares but never implements,
    include/spmv_ellpack.h:50-51)."""
    w = csr.max_row_nnz if width is None else width
    if w < csr.max_row_nnz:
        raise ValueError(f"width {w} < max row nnz {csr.max_row_nnz}")
    row_lens = np.diff(csr.row_ptr)
    col = np.repeat(np.arange(csr.num_rows, dtype=np.int64).reshape(-1, 1), max(w, 1),
                    axis=1)[:, :w]
    val = np.zeros((csr.num_rows, w), dtype=csr.val.dtype)
    if csr.nnz:
        rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), row_lens)
        pos = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.row_ptr[:-1], row_lens)
        col[rows, pos] = csr.col_idx
        val[rows, pos] = csr.val
        if w > 1:
            col = _pad_with_last_column(col, row_lens, w)
    return ELLMatrix(num_rows=csr.num_rows, num_cols=csr.num_cols, width=w, col=col, val=val,
                     grid_size=csr.grid_size)


def csr_to_dia(csr: CSRMatrix, max_diags: int = 4096) -> DIAMatrix:
    """CSR -> DIA.  Raises if the matrix has more than ``max_diags`` distinct diagonals
    (it then belongs on the ELL path)."""
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    offs = csr.col_idx - rows
    offsets = np.unique(offs)
    if offsets.shape[0] > max_diags:
        raise ValueError(f"matrix has {offsets.shape[0]} distinct diagonals (> {max_diags}); "
                         "use ELL")
    data = np.zeros((offsets.shape[0], csr.num_rows), dtype=csr.val.dtype)
    dsel = np.searchsorted(offsets, offs)
    np.add.at(data, (dsel, rows), csr.val)
    return DIAMatrix(num_rows=csr.num_rows, num_cols=csr.num_cols,
                     offsets=offsets.astype(np.int64), data=data, grid_size=csr.grid_size)


def stencil5_to_dia(st: Stencil5) -> DIAMatrix:
    """Stencil5 -> DIA straight from the coefficient planes: the five diagonals sit at
    offsets [−g, −1, 0, +1, +g] and ``data[d, i]`` is plane [N, W, C, E, S] at point i; the
    planes' Dirichlet zeros are the DIA layout's out-of-band zeros."""
    g = st.grid_size
    if g < 2:
        # g == 1: offsets ±1 and ±g collide; go through CSR
        return csr_to_dia(stencil5_to_csr(st))
    n = g * g
    if st.planes is not None:
        planes = np.asarray(st.planes)
        data = np.stack([planes[p].reshape(n) for p in (N, W, C, E, S)])
    else:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        diag, offdiag = st.constant
        # planes-free constant operand: the (5, n) rows written directly, in f32 (exact for
        # the benchmark's 5/−1; the device packs cast to the operator's dtype anyway)
        data = np.full((5, n), offdiag, dtype=np.float32)
        data[2] = diag  # row order N, W, C, E, S: C is offset 0, at index 2
        data[0, :g] = 0.0        # first grid row: no north neighbour
        data[4, n - g:] = 0.0    # last grid row: no south neighbour
        data[1, 0::g] = 0.0      # j == 0: no west neighbour
        data[3, g - 1::g] = 0.0  # j == g−1: no east neighbour
    return DIAMatrix(num_rows=n, num_cols=n, offsets=np.array([-g, -1, 0, 1, g], dtype=np.int64),
                     data=data, grid_size=g)


def stencil5_to_ell(st: Stencil5) -> ELLMatrix:
    """Stencil5 -> ELLPACK straight from the planes, bit-equal to ``stencil5_to_csr`` then
    ``csr_to_ell``: the candidate columns [i−g, i−1, i, i+1, i+g] are already sorted, zero
    coefficients are dropped as ``stencil5_to_csr`` drops them, and pad slots repeat the
    row's last real column."""
    g = st.grid_size
    n = g * g
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        diag, offdiag = st.constant
        if g >= 3 and diag != 0.0 and offdiag != 0.0:
            return _stencil5_const_to_ell(g, float(diag), float(offdiag))
        from .generate import make_stencil5

        st = make_stencil5(g, *st.constant, dtype=np.float32)
    i, j = np.meshgrid(np.arange(g, dtype=np.int64), np.arange(g, dtype=np.int64),
                       indexing="ij")
    cand_col = np.empty((5, g, g), np.int64)
    valid = np.empty((5, g, g), bool)
    vals = np.asarray(st.planes)
    for p, (di, dj) in ((N, (-1, 0)), (W, (0, -1)), (C, (0, 0)), (E, (0, 1)), (S, (1, 0))):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < g) & (jj >= 0) & (jj < g)
        cand_col[p] = np.where(ok, ii * g + jj, 0)
        valid[p] = ok & (vals[p] != 0.0)
    cc = cand_col.reshape(5, n).T          # (n, 5) sorted candidate columns
    vv = vals.reshape(5, n).T
    mm = valid.reshape(5, n).T
    lens = mm.sum(axis=1)
    w = int(lens.max()) if n else 0
    pos = np.cumsum(mm, axis=1) - 1        # slot of each valid candidate
    rsel = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, 5))[mm]
    col = np.repeat(np.arange(n, dtype=np.int64).reshape(-1, 1), max(w, 1), axis=1)[:, :w]
    val = np.zeros((n, w), dtype=vv.dtype)
    col[rsel, pos[mm]] = cc[mm]
    val[rsel, pos[mm]] = vv[mm]
    if w > 1:
        col = _pad_with_last_column(col, lens, w)
    return ELLMatrix(num_rows=n, num_cols=n, width=w, col=col, val=val, grid_size=g)


def _stencil5_const_to_ell(g: int, diag: float, offdiag: float) -> ELLMatrix:
    """Analytic ELL of the constant 5-point stencil (g ≥ 3, both coefficients nonzero).

    Every row is first written as an interior row, col = r + (−g, −1, 0, +1, +g) and
    val = (o, o, d, o, o); then the 4g − 4 boundary rows are rewritten with their real
    columns packed to the left and the pad-with-last-column rule.  Bit-equal to the
    general path of ``stencil5_to_ell``."""
    n = g * g
    r = np.arange(n, dtype=np.int64)
    col = np.stack([r - g, r - 1, r, r + 1, r + g], axis=1)
    val = np.empty((n, 5), np.float32)
    val[:] = np.array([offdiag, offdiag, diag, offdiag, offdiag], np.float32)
    edge = np.concatenate([
        np.arange(g, dtype=np.int64),                    # i = 0 (both corners included)
        np.arange(n - g, n, dtype=np.int64),             # i = g−1 (both corners included)
        np.arange(g, n - g, g, dtype=np.int64),          # j = 0, 0 < i < g−1
        np.arange(2 * g - 1, n - g, g, dtype=np.int64),  # j = g−1, 0 < i < g−1
    ])
    ei, ej = edge // g, edge % g
    cand = np.stack([edge - g, edge - 1, edge, edge + 1, edge + g], axis=1)
    ok = np.stack([ei > 0, ej > 0, np.ones_like(edge, bool), ej < g - 1, ei < g - 1], axis=1)
    vals5 = np.array([offdiag, offdiag, diag, offdiag, offdiag], np.float32)
    m = edge.shape[0]
    lens = ok.sum(axis=1)
    pos = np.cumsum(ok, axis=1) - 1
    ecol = np.zeros((m, 5), np.int64)
    evalv = np.zeros((m, 5), np.float32)
    rr = np.broadcast_to(np.arange(m)[:, None], (m, 5))[ok]
    ecol[rr, pos[ok]] = cand[ok]
    evalv[rr, pos[ok]] = np.broadcast_to(vals5, (m, 5))[ok]
    last = ecol[np.arange(m), lens - 1]  # lens ≥ 3 for g ≥ 2: always a real column
    ecol = np.where(np.arange(5)[None, :] >= lens[:, None], last[:, None], ecol)
    col[edge] = ecol
    val[edge] = evalv
    return ELLMatrix(num_rows=n, num_cols=n, width=5, col=col, val=val, grid_size=g)


def csr_to_stencil5(csr: CSRMatrix, grid_size: Optional[int] = None) -> Stencil5:
    """The five coefficient planes of a CSR matrix that is a 5-point stencil on a g×g
    grid.  The structure is checked, not trusted (the reference's STENCIL5 init trusts the
    sorted-CSR layout, spmv_stencil_csr_direct.cu:194-225): any nonzero outside the
    pattern, a W/E entry that wraps across a grid row, or a duplicate entry raises."""
    g = grid_size or csr.grid_size
    if g <= 0:
        g = int(round(np.sqrt(csr.num_rows)))
    if g * g != csr.num_rows or csr.num_rows != csr.num_cols:
        raise ValueError(f"matrix ({csr.num_rows}x{csr.num_cols}) is not a g^2 square, g={g}")
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    offs = csr.col_idx - rows
    # SpMV would add duplicate (row, col) entries; the plane assignment would keep one
    dup = (np.diff(csr.col_idx) == 0) & (rows[1:] == rows[:-1])
    if np.any(dup):
        raise ValueError("matrix has duplicate (row, col) entries — accumulate them first")
    planes = np.zeros((5, g, g), dtype=csr.val.dtype)
    i = rows // g
    j = rows % g
    plane_of = {-g: N, -1: W, 0: C, 1: E, g: S}
    for off, p in plane_of.items():
        sel = offs == off
        planes[p, i[sel], j[sel]] = csr.val[sel]
    if np.any(~np.isin(offs, list(plane_of))):
        raise ValueError("matrix has nonzeros outside the 5-point stencil pattern")
    if np.any((offs == -1) & (j == 0)) or np.any((offs == 1) & (j == g - 1)):
        raise ValueError("W/E nonzero wraps across a grid row — not a 5-point stencil")
    cvals = None
    interior = planes[:, 1:-1, 1:-1]
    if g > 2 and interior.size:
        d0 = interior[C].flat[0]
        o0 = interior[N].flat[0]
        if np.all(interior[C] == d0) and all(np.all(interior[p] == o0) for p in (N, W, E, S)):
            cvals = (float(d0), float(o0))
    return Stencil5(grid_size=g, planes=planes, constant=cvals)


def stencil5_to_csr(st: Stencil5) -> CSRMatrix:
    """A Stencil5 as sorted CSR.  A planes-free constant operand makes its host planes
    here (f32): only the generic operators on the host need them."""
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        from .generate import make_stencil5

        st = make_stencil5(st.grid_size, *st.constant, dtype=np.float32)
    g = st.grid_size
    n = g * g
    i, j = np.meshgrid(np.arange(g, dtype=np.int64), np.arange(g, dtype=np.int64), indexing="ij")
    row = (i * g + j).ravel()
    entries = []
    for p, (di, dj) in ((N, (-1, 0)), (W, (0, -1)), (C, (0, 0)), (E, (0, 1)), (S, (1, 0))):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < g) & (jj >= 0) & (jj < g)
        v = st.planes[p]
        sel = ok.ravel() & (v.ravel() != 0.0)
        entries.append((row[sel], (ii * g + jj).ravel()[sel], v.ravel()[sel]))
    return coo_to_csr(COOMatrix(num_rows=n, num_cols=n,
                                row=np.concatenate([e[0] for e in entries]),
                                col=np.concatenate([e[1] for e in entries]),
                                val=np.concatenate([e[2] for e in entries]), grid_size=g))


def stencil27_to_csr(st: Stencil27) -> CSRMatrix:
    """HPCG's rows of a Stencil27 as sorted CSR, written from its definition on the host
    (small sizes and tests): for each row, each offset of ``STENCIL27_OFFSETS`` whose
    neighbour lies on the grid, in that order (ascending columns), the diagonal's value at
    the point itself and the off-diagonal's elsewhere.  Every such entry is stored, as
    HPCG stores it, whatever its value."""
    nx, ny, nz = st.nx, st.ny, st.nz
    if min(nx, ny, nz) < 1:
        raise ValueError(f"a Stencil27 needs nx, ny, nz >= 1, got {nx} x {ny} x {nz}")
    diag, offdiag = st.constant
    n = st.num_rows
    iz, iy, ix = (a.ravel() for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                                 indexing="ij"))
    cand = np.empty((n, 27), np.int64)
    ok = np.empty((n, 27), bool)
    for k, (sz, sy, sx) in enumerate(STENCIL27_OFFSETS):
        jz, jy, jx = iz + sz, iy + sy, ix + sx
        ok[:, k] = (jz >= 0) & (jz < nz) & (jy >= 0) & (jy < ny) & (jx >= 0) & (jx < nx)
        cand[:, k] = (jz * ny + jy) * nx + jx
    vals = np.full(27, offdiag, np.float64)
    vals[STENCIL27_CENTER] = diag
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(ok.sum(axis=1), out=row_ptr[1:])
    return CSRMatrix(num_rows=n, num_cols=n, row_ptr=row_ptr, col_idx=cand[ok],
                     val=np.broadcast_to(vals, (n, 27))[ok].copy())

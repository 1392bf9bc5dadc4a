"""Operand and vector synthesis for the port.

The host half is the port's own copy of ``tpusparse/generate.py``'s (plain numpy):
``make_stencil5`` (the host Stencil5 with its planes), ``write_matrix_market_stencil5``
(the reference's stencil .mtx writer) and ``stencil5_spmv_checksums`` (the analytic Sum and
Norm2 of y = A·ones).  The device half builds the stencil's coefficient planes
(``make_stencil5_planes_device``), its ELL, DIA and CSR operands
(``make_stencil5_ell_device``, ``make_stencil5_dia_device``, ``make_stencil5_csr_device``)
and the canonical x = ones / b = ones field (``ones_field``) directly on the target device
in the target dtype, and HPCG's 27-point stencil's ELL operand
(``make_stencil27_ell_device``).  The planes, the ELL operand and b = ones (``ones_band``)
also come as one rank's row band with zero pad rows, for the sharded solver; the planes
and b = ones also as one rank's block of rows and columns, for its 2-D decomposition.
Every device maker takes ``dtype=torch.bfloat16`` and fills in it directly, never through
an f32 copy (5, −1, 0 and 1 are exact in bf16).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .formats import STENCIL27_CENTER, STENCIL27_OFFSETS, C, E, N, S, Stencil5, W

# the reference generator's coefficients (src/io/io.cu:375): Laplacian + mass term
DEFAULT_DIAG = 5.0
DEFAULT_OFFDIAG = -1.0


def stencil5_nnz(grid_size: int) -> int:
    """Exact nnz of the 5-point stencil matrix (reference precount io.cu:327-340)."""
    g = grid_size
    return 5 * g * g - 4 * g


def make_stencil5(grid_size: int, diag: float = DEFAULT_DIAG, offdiag: float = DEFAULT_OFFDIAG,
                  dtype=np.float64) -> Stencil5:
    """The host Stencil5: coefficient planes with Dirichlet-zero coefficients where a
    neighbour falls off the grid."""
    g = int(grid_size)
    if g < 1:
        raise ValueError("grid_size must be >= 1")
    planes = np.zeros((5, g, g), dtype=dtype)
    planes[C] = diag
    planes[N, 1:, :] = offdiag  # row 0 has no north neighbour
    planes[S, :-1, :] = offdiag  # the last row has no south neighbour
    planes[W, :, 1:] = offdiag  # column 0 has no west neighbour
    planes[E, :, :-1] = offdiag  # the last column has no east neighbour
    return Stencil5(grid_size=g, planes=planes, constant=(float(diag), float(offdiag)))


def write_matrix_market_stencil5(path: str, grid_size: int, diag: float = DEFAULT_DIAG,
                                 offdiag: float = DEFAULT_OFFDIAG, chunk_rows: int = 512) -> int:
    """Write the stencil matrix as a 1-based .mtx with the reference's header
    (src/io/io.cu:322-399).  Returns the nnz written.  The native writer when its library
    is available, else the Python one.

    The native writer emits each grid point's entries in the reference's C, N, S, W, E
    order (io.cu:373-391); the Python writer groups them by kind per chunk of grid rows.
    Both files parse to the same matrix (the readers sort each row), but they differ line
    by line."""
    from . import native

    if native.available():
        return native.write_stencil5_mtx(path, grid_size, diag, offdiag)
    return _write_stencil5_python(path, grid_size, diag, offdiag, chunk_rows)


def _write_stencil5_python(path, grid_size, diag, offdiag, chunk_rows=512) -> int:
    g = int(grid_size)
    nnz = stencil5_nnz(g)
    n = g * g
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% STENCIL_GRID_SIZE {g}\n")
        f.write(f"{n} {n} {nnz}\n")
        jj = np.arange(g, dtype=np.int64)
        for i0 in range(0, g, chunk_rows):
            lines = []
            for i in range(i0, min(i0 + chunk_rows, g)):
                base = i * g + jj + 1  # 1-based row index
                recs = [(base, base, np.full(g, diag))]
                if i > 0:
                    recs.append((base, base - g, np.full(g, offdiag)))
                if i < g - 1:
                    recs.append((base, base + g, np.full(g, offdiag)))
                recs.append((base[1:], base[1:] - 1, np.full(g - 1, offdiag)))
                recs.append((base[:-1], base[:-1] + 1, np.full(g - 1, offdiag)))
                for r, c, v in recs:
                    lines.extend(f"{rr} {cc} {vv:.17g}\n" for rr, cc, vv in zip(r, c, v))
            f.write("".join(lines))
    return nnz


def stencil5_spmv_checksums(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG):
    """The exact (Sum(y), Norm2(y)) of y = A·ones, in float64: y at a point is diag +
    offdiag × its number of neighbours (the oracle of the reference's tests,
    tests/test_wrapper_basic.cpp:115-121)."""
    g = grid_size
    # neighbour counts: 4 interior, 3 edge, 2 corner (the smallest grids by hand)
    if g == 1:
        counts = {0: 1}
    elif g == 2:
        counts = {2: 4}
    else:
        counts = {2: 4, 3: 4 * (g - 2), 4: (g - 2) ** 2}
    sum_y = 0.0
    norm2 = 0.0
    for nb, count in counts.items():
        yv = diag + offdiag * nb
        sum_y += count * yv
        norm2 += count * yv * yv
    return sum_y, float(np.sqrt(norm2))


def ones_field(grid_size: int, dtype=torch.float32, device="cuda"):
    """The reference's canonical input vector x = ones as a (g, g) field, made on the
    device in the target dtype (no host staging copy)."""
    return torch.ones((grid_size, grid_size), dtype=dtype, device=resolve_device(device))


def make_stencil5_planes_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                                dtype=torch.float32, device="cuda", rows=None, pad_rows=0,
                                cols=None):
    """The (5, g, g) coefficient planes of the g×g stencil, in the order N, W, C, E, S,
    made on the device in ``dtype``: the port of ``tpusparse.generate.
    make_stencil5_planes_device``, with the masks of ``make_stencil5`` (row 0 has no N, the
    last row no S, column 0 no W, the last column no E).

    ``rows=(lo, hi)`` makes only grid rows [lo, hi) of them, and ``pad_rows`` appends that
    many rows of zero planes: a rank's band, (5, hi − lo + pad_rows, g), with N masked only
    where the band holds global row 0 and S only where it holds row g − 1, the planes the
    JAX package's ``_sharded_planes`` (``cg_sharded.py:249-268``) made whole and sharded.
    ``cols=(lo, hi)`` likewise makes only grid columns [lo, hi): a rank's block of the 2-D
    decomposition, (5, rows, hi − lo), with W masked only where the block holds global
    column 0 and E only where it holds column g − 1 (the JAX package's ``_sharded_planes``
    with ``P(None, "x", "y")``, ``cg_sharded.py:813-825``).  A block's inner side columns
    keep their −1: the solver adds the neighbour's column times it.

    One tensor is allocated and each plane filled in place, so the peak footprint is the
    output alone: five (g, g) planes and a ``torch.stack`` would double it (16.8 GB for
    f32 at 20480²).  bfloat16 is filled directly, never through an f32 copy; 5, -1 and 0
    are exact in it."""
    g = int(grid_size)
    if g < 1:
        raise ValueError("grid_size must be >= 1")
    lo, hi = _band(g, rows, pad_rows)
    c0, c1 = _band(g, cols, 0, "columns")
    planes = torch.empty((5, hi - lo + pad_rows, c1 - c0), dtype=dtype,
                         device=resolve_device(device))
    real = planes[:, :hi - lo]
    real[C].fill_(diag)
    for d in (N, S, W, E):
        real[d].fill_(offdiag)
    if lo == 0 and hi > 0:
        real[N, 0].zero_()
    if lo < g <= hi:
        real[S, -1].zero_()
    if c0 == 0 and c1 > 0:
        real[W, :, 0].zero_()
    if c0 < g <= c1:
        real[E, :, -1].zero_()
    planes[:, hi - lo:].zero_()
    return planes


def ones_band(grid_size: int, rows=None, pad_rows=0, dtype=torch.float32, device="cuda",
              cols=None, out=None):
    """The canonical b = ones on grid rows [lo, hi) (``rows``, default all), with
    ``pad_rows`` zero rows appended: a shard's band of the right-hand side, made on the
    device (the JAX package's ``_local_ones_b``, ``cg_sharded.py:406-412``); with
    ``cols=(lo, hi)`` only those columns, a shard's block (the JAX 2-D solver's
    ``jnp.ones((g // nr, g // nc))``, ``cg_sharded.py:1072``).  Written into ``out`` (a
    field of that shape) when given, else into a new field."""
    g = int(grid_size)
    lo, hi = _band(g, rows, pad_rows)
    c0, c1 = _band(g, cols, 0, "columns")
    shape = (hi - lo + pad_rows, c1 - c0)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    elif tuple(out.shape) != shape:
        raise ValueError(f"out must be a {shape} field, got {tuple(out.shape)}")
    out.fill_(1)
    out[hi - lo:].zero_()
    return out


def _band(g, rows, pad_rows, what="rows"):
    """(lo, hi) of a band of a g-row grid (or of a block's columns), checked."""
    lo, hi = (0, g) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= g or pad_rows < 0:
        raise ValueError(f"{what} {rows} with {pad_rows} pad rows do not fit a grid of {g} "
                         f"{what}")
    return lo, hi


def stencil5_ell_device_ok(grid_size: int, diag, offdiag) -> bool:
    """Whether ``make_stencil5_ell_device`` takes this stencil: the contract of the analytic
    pack it ports (g ≥ 3, both coefficients nonzero)."""
    return int(grid_size) >= 3 and diag != 0.0 and offdiag != 0.0


def stencil5_dia_device_ok(grid_size: int) -> bool:
    """Whether ``make_stencil5_dia_device`` takes this grid: g ≥ 2 (at g = 1 the offsets
    ±1 and ±g collide)."""
    return int(grid_size) >= 2


def make_stencil5_ell_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                             dtype=torch.float32, device="cuda", rows=None, pad_rows=0):
    """The slot-major ELL operand of the constant g×g stencil, made on the device: values
    (5, g²) in ``dtype`` and columns (5, g²) int32, the operand ``convert.ell_from_numpy``
    makes of ``formats.stencil5_to_ell`` — the port of its analytic path,
    ``formats._stencil5_const_to_ell``, and bit-equal to it, with its contract: g ≥ 3 and
    both coefficients nonzero (ValueError otherwise).

    Every row is first written as an interior row, columns r + (−g, −1, 0, +1, +g) with
    values (o, o, d, o, o); then the boundary rows are rewritten: their real columns
    packed to the left in N, W, C, E, S order, the pad slots holding the last real column
    with value 0.  Values round through float32, as the host pack stores them.  At 20480²
    the host pack would be 16.8 GB of int64 columns and 8.4 GB of values.

    ``rows=(lo, hi)`` makes only the points of grid rows [lo, hi), (5, (hi − lo)·g), and
    ``pad_rows`` appends that many rows of points with zero values whose columns all point
    at the point itself, (hi + t)·g + j: a rank's band, columns global, as the JAX
    package's sharded ``csr`` operand (``cg_sharded.py:303-310``)."""
    g = int(grid_size)
    if not stencil5_ell_device_ok(g, diag, offdiag):
        raise ValueError("the analytic stencil ELL needs g >= 3 and nonzero coefficients "
                         "(formats.stencil5_to_ell packs the others on the host)")
    lo, hi = _band(g, rows, pad_rows)
    if (hi + pad_rows) * g >= 2 ** 31 - g:
        raise ValueError(f"grid {g} too large for int32 columns")
    dev = resolve_device(device)
    p0, p1 = lo * g, (hi + pad_rows) * g  # the band's points, pad rows included
    d32, o32 = float(np.float32(diag)), float(np.float32(offdiag))
    cols = torch.empty((5, p1 - p0), dtype=torch.int32, device=dev)
    torch.arange(p0, p1, dtype=torch.int32, device=dev, out=cols[2])
    for slot, shift in ((0, -g), (1, -1), (3, 1), (4, g)):
        torch.add(cols[2], shift, out=cols[slot])
    vals = torch.full((5, p1 - p0), o32, dtype=dtype, device=dev)
    vals[2].fill_(d32)
    real = (hi - lo) * g
    cols[:, real:] = cols[2, real:]  # pad rows: every slot at the point itself, value 0
    vals[:, real:] = 0

    # the boundary points of the band: all of rows 0 and g-1, and columns 0 and g-1 of
    # the rows between them
    full = [torch.arange(i * g, (i + 1) * g, device=dev) for i in sorted({0, g - 1})
            if lo <= i < hi]
    first = max(lo, 1)
    mid = torch.arange(first, max(first, min(hi, g - 1)), device=dev) * g
    edge = torch.cat([*full, mid, mid + (g - 1)])
    ei, ej = edge // g, edge % g
    cand = torch.stack([edge - g, edge - 1, edge, edge + 1, edge + g], dim=1)
    ok = torch.stack([ei > 0, ej > 0, torch.ones_like(ei, dtype=torch.bool), ej < g - 1,
                      ei < g - 1], dim=1)
    m = edge.numel()
    lens = ok.sum(dim=1)
    pos = ok.cumsum(dim=1) - 1
    rr = torch.arange(m, device=dev)[:, None].expand(m, 5)[ok]
    ecol = torch.zeros((m, 5), dtype=torch.int64, device=dev)
    ecol[rr, pos[ok]] = cand[ok]
    evals = torch.zeros((m, 5), dtype=dtype, device=dev)
    vals5 = torch.tensor([o32, o32, d32, o32, o32], dtype=dtype, device=dev)
    evals[rr, pos[ok]] = vals5.expand(m, 5)[ok]
    last = ecol[torch.arange(m, device=dev), lens - 1]  # lens >= 3: always a real column
    pad = torch.arange(5, device=dev)[None, :] >= lens[:, None]
    ecol = torch.where(pad, last[:, None], ecol)
    cols[:, edge - p0] = ecol.T.to(torch.int32)
    vals[:, edge - p0] = evals.T
    return vals, cols


def make_stencil27_ell_device(nx: int, ny: int, nz: int, diag=26.0, offdiag=-1.0,
                              dtype=torch.float64, device="cuda"):
    """The slot-major ELL operand of HPCG's 27-point stencil on the nx×ny×nz grid
    (``formats.Stencil27``), made on the device: values (27, n) in ``dtype`` and columns
    (27, n) int32, n = nx·ny·nz.  Slot k is the neighbour offset
    ``formats.STENCIL27_OFFSETS[k]`` (HPCG's (sz, sy, sx) order): for a point whose
    neighbour lies on the grid, the neighbour's row and the off-diagonal (the diagonal in
    slot 13); for one whose neighbour is off the grid, the point's own row and value 0.

    Every row's real entries keep their order, and the kernel adds a pad slot's product, 0,
    without changing the sum, so y equals that of ``formats.csr_to_ell`` of
    ``formats.stencil27_to_csr``, whose pad slots come after the real ones, bit for bit.

    Built slot by slot in place: each slot's columns are the point's own row (a copy of
    slot 13's ``arange``), shifted by the offset on the box of points whose neighbour is
    on the grid, and its values are filled on that box.  Nothing is staged beside the
    operand (at 512³ it is 29.0 GB of f64 values and 14.5 GB of columns; a (27, n) int64
    index tensor would be another 29 GB).  ValueError for an empty grid, or one of 2^31
    points or more (int32 columns)."""
    nx, ny, nz = int(nx), int(ny), int(nz)
    if min(nx, ny, nz) < 1:
        raise ValueError(f"grid {nx} x {ny} x {nz}: every side must be >= 1")
    n = nx * ny * nz
    if n >= 2 ** 31:
        raise ValueError(f"grid {nx} x {ny} x {nz} too large for int32 columns")
    dev = resolve_device(device)
    vals = torch.zeros((27, n), dtype=dtype, device=dev)
    cols = torch.empty((27, n), dtype=torch.int32, device=dev)
    torch.arange(n, dtype=torch.int32, device=dev, out=cols[STENCIL27_CENTER])
    for k, (sz, sy, sx) in enumerate(STENCIL27_OFFSETS):
        if k != STENCIL27_CENTER:
            cols[k].copy_(cols[STENCIL27_CENTER])
        # the points whose neighbour (iz + sz, iy + sy, ix + sx) lies on the grid
        box = (slice(max(0, -sz), nz - max(0, sz)), slice(max(0, -sy), ny - max(0, sy)),
               slice(max(0, -sx), nx - max(0, sx)))
        cols[k].view(nz, ny, nx)[box].add_((sz * ny + sy) * nx + sx)
        vals[k].view(nz, ny, nx)[box].fill_(diag if k == STENCIL27_CENTER else offdiag)
    return vals, cols


def make_stencil5_csr_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                             dtype=torch.float32, device="cuda", chunk_points=2 ** 22):
    """The sorted CSR of the constant g×g stencil, made on the device: row_ptr (g² + 1,)
    int32, col (nnz,) int32 and val (nnz,) in ``dtype``, equal array for array to
    ``formats.stencil5_to_csr`` of ``Stencil5(g, None, (diag, offdiag))``: each row's
    columns ascending (N, W, C, E, S), no entry where a neighbour is off the grid or its
    coefficient is 0 (the host CSR drops zeros), values rounded through float32 as the host
    planes store them.  ValueError when nnz does not fit int32 row pointers.

    Built ``chunk_points`` grid points at a time, with 64-bit index arithmetic (5·g² reaches
    2.1e9 at 20480²), so the peak stays near the output: 18.5 GB in f32 at 20480² (26.8 GB
    in f64), where the host CSR is 25 GB and takes minutes."""
    g = int(grid_size)
    if g < 1:
        raise ValueError("grid_size must be >= 1")
    n = g * g
    d32, o32 = float(np.float32(diag)), float(np.float32(offdiag))
    nnz = n * (d32 != 0.0) + 4 * g * (g - 1) * (o32 != 0.0)
    if nnz >= 2 ** 31:
        raise ValueError(f"grid {g}: {nnz} entries do not fit int32 row pointers")
    dev = resolve_device(device)
    row_ptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    row_ptr[0] = 0
    col = torch.empty(nnz, dtype=torch.int32, device=dev)
    val = torch.empty(nnz, dtype=dtype, device=dev)
    vals5 = torch.tensor([o32, o32, d32, o32, o32], dtype=dtype, device=dev)
    nonzero5 = vals5 != 0
    start = 0
    for p0 in range(0, n, chunk_points):
        pts = torch.arange(p0, min(p0 + chunk_points, n), dtype=torch.int64, device=dev)
        i, j = pts // g, pts % g
        cand = torch.stack([pts - g, pts - 1, pts, pts + 1, pts + g], dim=1)
        ok = torch.stack([i > 0, j > 0, torch.ones_like(i, dtype=torch.bool), j < g - 1,
                          i < g - 1], dim=1) & nonzero5
        lens = ok.sum(dim=1)
        row_ptr[p0 + 1:p0 + 1 + pts.numel()] = lens.cumsum(0).add_(start).to(torch.int32)
        stop = start + int(lens.sum())
        col[start:stop] = cand[ok].to(torch.int32)  # row-major: each row ascending
        val[start:stop] = vals5.expand_as(ok)[ok]
        start = stop
    return row_ptr, col, val


def make_stencil5_dia_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                             dtype=torch.float32, device="cuda"):
    """The DIA operand of the g×g stencil, made on the device: data (5, g²) in ``dtype``
    and offsets (−g, −1, 0, +1, +g) int64.  By ``formats.stencil5_to_dia``'s own account
    the DIA data of the stencil is exactly its coefficient planes N, W, C, E, S, with the
    planes' edge masks as the zeros where a diagonal leaves the matrix, so this is
    ``make_stencil5_planes_device`` seen as (5, g²).  Values round through float32, as the
    host pack stores them, so this equals ``convert.dia_from_numpy`` of
    ``formats.stencil5_to_dia``.  g ≥ 2 (at g = 1 the offsets collide; ValueError)."""
    g = int(grid_size)
    if not stencil5_dia_device_ok(g):
        raise ValueError("the stencil's DIA needs g >= 2: at g = 1 the offsets ±1 and ±g "
                         "collide")
    data = make_stencil5_planes_device(g, float(np.float32(diag)), float(np.float32(offdiag)),
                                       dtype=dtype, device=device)
    offsets = torch.tensor([-g, -1, 0, 1, g], dtype=torch.int64, device=data.device)
    return data.reshape(5, g * g), offsets

"""Matrix Market I/O of the port: its own copy of ``tpusparse/io_mtx.py``.

Parity with the reference's reader (src/io/io.cu:73-310):
  - the banner tells ``general`` from ``symmetric`` (read_matrix_type, io.cu:32-62);
  - a ``% STENCIL_GRID_SIZE <g>`` comment is read into ``grid_size`` (io.cu:130-132);
  - entries are 1-based on disk and 0-based in memory (io.cu:153-166);
  - a symmetric file stores the lower triangle, expanded here to the full matrix
    (read_matrix_symtogen, io.cu:189-310).

The native reader (``native``) parses when its library is available; the numpy reader
below gives the same matrix, slower.
"""

from __future__ import annotations

import numpy as np

from . import native
from .formats import COOMatrix


def read_matrix_type(path: str) -> str:
    """'general' or 'symmetric', from the banner (reference io.cu:32-62)."""
    with open(path, "r") as f:
        banner = f.readline()
    if not banner.startswith("%%MatrixMarket"):
        raise ValueError(f"{path}: missing MatrixMarket banner")
    toks = banner.lower().split()
    if "matrix" not in toks or "coordinate" not in toks:
        raise ValueError(f"{path}: only 'matrix coordinate' files are supported")
    # a 'complex' file would lose its imaginary parts and a 'pattern' file has no values:
    # refuse both (the reference reads real files only)
    if not ("real" in toks or "integer" in toks):
        raise ValueError(f"{path}: unsupported field type in banner (need real/integer): "
                         f"{banner.strip()}")
    if "symmetric" in toks:
        return "symmetric"
    if "general" in toks:
        return "general"
    raise ValueError(f"{path}: unsupported symmetry qualifier in banner: {banner.strip()}")


def _read_header(f):
    """Consume the comment lines, reading STENCIL_GRID_SIZE; (rows, cols, nnz, grid)."""
    grid_size = 0
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF before size line")
        if line.startswith("%"):
            if "STENCIL_GRID_SIZE" in line:
                grid_size = int(line.split()[-1])
            continue
        parts = line.split()
        if len(parts) != 3:
            raise ValueError(f"malformed size line: {line.strip()}")
        return int(parts[0]), int(parts[1]), int(parts[2]), grid_size


def load_matrix_market(path: str) -> COOMatrix:
    """A .mtx file as COO (reference load_matrix_market, io.cu:73-93); a symmetric file's
    off-diagonal (i, j) also yields (j, i)."""
    kind = read_matrix_type(path)
    if native.available():
        rows, cols, r, c, v, grid = native.read_mtx(path)
    else:
        with open(path, "r") as f:
            f.readline()  # banner
            rows, cols, nnz, grid = _read_header(f)
            data = np.loadtxt(f, dtype=np.float64, ndmin=2, comments="%")
        if data.size == 0:
            data = np.zeros((0, 3))
        if data.shape[0] != nnz:
            raise ValueError(f"{path}: header promises {nnz} entries, found {data.shape[0]}")
        r = data[:, 0].astype(np.int64) - 1
        c = data[:, 1].astype(np.int64) - 1
        v = data[:, 2].astype(np.float64)
    if kind == "symmetric":
        off = r != c
        r, c = np.concatenate([r, c[off]]), np.concatenate([c, r[off]])
        v = np.concatenate([v, v[off]])
    coo = COOMatrix(num_rows=rows, num_cols=cols, row=r, col=c, val=v, grid_size=grid)
    coo.validate()
    return coo


def write_matrix_market(path: str, coo: COOMatrix) -> None:
    """A general COO matrix, 1-based, with the STENCIL_GRID_SIZE comment when known."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if coo.grid_size:
            f.write(f"% STENCIL_GRID_SIZE {coo.grid_size}\n")
        f.write(f"{coo.num_rows} {coo.num_cols} {coo.nnz}\n")
        for chunk in range(0, coo.nnz, 1 << 20):
            sl = slice(chunk, min(chunk + (1 << 20), coo.nnz))
            f.write("".join(
                f"{rr} {cc} {vv:.17g}\n"
                for rr, cc, vv in zip((coo.row[sl] + 1).tolist(), (coo.col[sl] + 1).tolist(),
                                      coo.val[sl].tolist())))

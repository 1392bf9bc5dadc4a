"""ctypes bindings of the port's native host I/O core (``csrc/host/mtxio.cpp``).

The port's own copy of ``tpusparse/native.py``.  Parsing ~10⁹ ASCII lines of a 20k×20k
Matrix Market file in Python is the slow step of the reference's workflow, so its C host
layer (src/io/io.cu, spmv_cusparse_csr.cu:62-170) has a C++ counterpart here: the reader,
the stencil writer and the COO -> sorted-CSR build.  This code runs on the host CPU.

``g++ -O3 -shared -fPIC`` builds the library at first use into
``tpusparse_torch/build/host/<hash>/libmtxio.so``, where ``<hash>`` covers the source and
the flags.  Where the build or the load fails (no compiler), ``available()`` is False and
every caller takes its numpy implementation instead: ``available()`` says which one ran.
The source sits in ``csrc/host/`` so that the CUDA build (``_build.sources``) never sees it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "mtxio.cpp"
BUILD = _PKG / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_LIB = None
_TRIED = False


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / h.hexdigest()[:16] / "libmtxio.so"


def _build(out: pathlib.Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")  # private until the rename
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    lib.mtx_read_header.restype = ctypes.c_int
    lib.mtx_read_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64p]
    lib.mtx_read_entries.restype = ctypes.c_int64
    lib.mtx_read_entries.argtypes = [ctypes.c_char_p, ctypes.c_int64, arr(np.int64),
                                     arr(np.int64), arr(np.float64)]
    lib.mtx_write_stencil5.restype = ctypes.c_int64
    lib.mtx_write_stencil5.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
                                       ctypes.c_double]
    lib.coo_to_csr_sorted.restype = ctypes.c_int
    lib.coo_to_csr_sorted.argtypes = [ctypes.c_int64, ctypes.c_int64, arr(np.int64),
                                      arr(np.int64), arr(np.float64), arr(np.int64),
                                      arr(np.int64), arr(np.float64)]
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _lock:
        if not _TRIED:
            path = _lib_path()
            if path.exists() or _build(path):
                try:
                    _LIB = _declare(ctypes.CDLL(str(path)))
                except OSError:
                    _LIB = None
            _TRIED = True
    return _LIB


def available() -> bool:
    """Whether the native library is in use (else the numpy readers and writers are)."""
    return _load() is not None


def read_mtx(path: str):
    """The native reader: (rows, cols, r, c, v, grid) with 0-based indices."""
    lib = _load()
    rows, cols, nnz, grid = (ctypes.c_int64() for _ in range(4))
    rc = lib.mtx_read_header(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                             ctypes.byref(nnz), ctypes.byref(grid))
    if rc != 0:
        raise ValueError(f"{path}: native header parse failed (rc={rc})")
    n = nnz.value
    r = np.empty(n, dtype=np.int64)
    c = np.empty(n, dtype=np.int64)
    v = np.empty(n, dtype=np.float64)
    got = lib.mtx_read_entries(path.encode(), n, r, c, v)
    if got != n:
        raise ValueError(f"{path}: header promises {n} entries, native reader found {got}")
    return rows.value, cols.value, r, c, v, grid.value


def write_stencil5_mtx(path: str, grid_size: int, diag: float, offdiag: float) -> int:
    nnz = _load().mtx_write_stencil5(path.encode(), grid_size, diag, offdiag)
    if nnz < 0:
        raise IOError(f"native stencil writer failed for {path}")
    return int(nnz)


def coo_to_csr_sorted(num_rows: int, r, c, v):
    """Native COO -> CSR with each row sorted by column.  Returns (row_ptr, col_idx, val)."""
    nnz = r.shape[0]
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    col_idx = np.empty(nnz, dtype=np.int64)
    val = np.empty(nnz, dtype=np.float64)
    rc = _load().coo_to_csr_sorted(num_rows, nnz, np.ascontiguousarray(r, np.int64),
                                   np.ascontiguousarray(c, np.int64),
                                   np.ascontiguousarray(v, np.float64), row_ptr, col_idx, val)
    if rc != 0:
        raise ValueError(f"native coo_to_csr failed (rc={rc})")
    return row_ptr, col_idx, val

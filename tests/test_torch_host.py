"""The port's own host code against the JAX package's, on the same numpy inputs.

``tpusparse_torch`` keeps its own copies of the host modules it needs (``formats``,
``io_mtx``, ``native``, the host half of ``generate``, ``bench.stats``/``export``/
``metrics``).  Each copy must give what the original gives: every matrix conversion (on
the stencil at g = 7 and 16, ``fixtures.tridiagonal`` and a random banded CSR), the
Matrix Market reader (a general and a symmetric file, native and numpy readers), the
stencil .mtx writer byte for byte, the analytic checksums, the statistics and export
dicts, and the byte models.  Arrays must be equal, not close: the copies compute the same
thing in the same order.

``carry`` turns a JAX-package matrix into the port's own through ``convert``, as the
other port tests do before they hand a matrix to the port.
"""

import fcntl
import os
import subprocess
import time

import numpy as np
import pytest

from tests import fixtures
from tests.test_kernels_gather import _random_banded_csr
from tpusparse import formats as jformats
from tpusparse import generate as jgenerate
from tpusparse import io_mtx as jio_mtx
from tpusparse import native as jnative
from tpusparse.bench import export as jexport
from tpusparse.bench import metrics as jmetrics
from tpusparse.bench import stats as jstats
from tpusparse_torch import convert, formats, generate, io_mtx, native
from tpusparse_torch.bench import export, metrics, stats


def carry(mat):
    """A JAX-package Stencil5, CSRMatrix or COOMatrix as the port's own matrix."""
    if isinstance(mat, jformats.Stencil5):
        return convert.stencil5_from_numpy(mat.grid_size, mat.planes, mat.constant)
    if isinstance(mat, jformats.COOMatrix):
        mat = jformats.coo_to_csr(mat)
    if isinstance(mat, jformats.CSRMatrix):
        return convert.csr_from_numpy(mat.num_rows, mat.num_cols, mat.row_ptr, mat.col_idx,
                                      mat.val, mat.grid_size)
    raise TypeError(f"cannot carry {type(mat)}")


# the JAX package's native library, which ``tpusparse.native`` builds in place
# (``make -C csrc``) at its first use in a process, and gives up on for the process's life
_JAX_LIB = os.path.join(os.path.dirname(os.path.abspath(jnative.__file__)), "..", "csrc",
                        "libmtxio.so")
# how long a worker waits for another process's build of that library to settle
_SETTLE_S = 60.0


def _jax_native(tmp_path_factory, monkeypatch):
    """Make sure the JAX package's native reader and writer are in use in this process,
    so that a ``native`` case compares native with native.  Every test process loads it
    at its first use (``tests/test_native.py`` at collection), building it in place; a
    process that loaded it half-written, or whose build lost a race with another
    process's, keeps its numpy fallback for its life.  Here the build is made again
    under a lock shared by the test processes, the process's verdict reset and the
    library loaded anew, until it loads or ``_SETTLE_S`` has passed: then the test fails
    naming the cause, never comparing the port's native writer with JAX's fallback."""
    if jnative.available():
        return
    lock = tmp_path_factory.getbasetemp().parent / "jax-native-build.lock"
    deadline, why = time.monotonic() + _SETTLE_S, "not tried"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while True:
                made = subprocess.run(["make", "-C", os.path.dirname(_JAX_LIB),
                                       "libmtxio.so"], capture_output=True, text=True,
                                      timeout=120)
                why = f"make exited {made.returncode}: {made.stderr.strip()[-300:]}"
                monkeypatch.setattr(jnative, "_TRIED", False)
                if jnative.available():
                    return
                if time.monotonic() > deadline:
                    break
                time.sleep(0.5)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    pytest.fail(f"the JAX package's native library ({os.path.normpath(_JAX_LIB)}) did not "
                f"load in this process within {_SETTLE_S:g} s ({why}): a native case "
                "would compare the port's native code with JAX's numpy fallback")


def _native_case(tmp_path_factory, monkeypatch, reader):
    """Set up a ``native`` case (``reader`` "native"; "native after a failed load" first
    leaves the JAX package as a process whose load gave up leaves it): both packages'
    native libraries in use, or the test fails naming which did not load."""
    if reader == "native after a failed load":
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", True)
    if not native.available():
        pytest.fail("the port's native library did not build")
    _jax_native(tmp_path_factory, monkeypatch)


def _same(port, ref):
    """Two containers of the two packages hold equal fields (arrays bit for bit)."""
    assert type(port).__name__ == type(ref).__name__
    for name, want in vars(ref).items():
        got = getattr(port, name)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def _stencil_planes(g, seed):
    """Random planes of a real stencil: zero coefficients where a neighbour is off the
    grid, as every .mtx gives them."""
    planes = np.random.RandomState(seed).randn(5, g, g)
    planes[jformats.N, 0] = planes[jformats.S, -1] = 0.0
    planes[jformats.W, :, 0] = planes[jformats.E, :, -1] = 0.0
    return planes


STENCILS = {
    "make_stencil5_7": lambda: jgenerate.make_stencil5(7),
    "make_stencil5_16": lambda: jgenerate.make_stencil5(16, 4.0, -0.5),
    "constant_planes_free_16": lambda: jformats.Stencil5(16, None, (5.0, -1.0)),
    "random_planes_7": lambda: jformats.Stencil5(7, _stencil_planes(7, 1)),
    "random_planes_16": lambda: jformats.Stencil5(16, _stencil_planes(16, 2)),
}
CSRS = {
    "tridiagonal": lambda: fixtures.tridiagonal(300),
    "random_banded": lambda: _random_banded_csr(500, 9, 4, seed=500),
    "stencil_16": lambda: jformats.stencil5_to_csr(jgenerate.make_stencil5(16)),
}


def test_plane_constants_match():
    assert (formats.N, formats.W, formats.C, formats.E, formats.S) == (
        jformats.N, jformats.W, jformats.C, jformats.E, jformats.S)
    assert formats.STENCIL_PLANE_NAMES == jformats.STENCIL_PLANE_NAMES


@pytest.mark.parametrize("name", list(STENCILS))
def test_stencil_conversions_match(name):
    ref = STENCILS[name]()
    st = carry(ref)
    _same(st, ref)
    assert st.nnz == ref.nnz
    csr = formats.stencil5_to_csr(st)
    _same(csr, jformats.stencil5_to_csr(ref))
    _same(formats.stencil5_to_dia(st), jformats.stencil5_to_dia(ref))
    _same(formats.stencil5_to_ell(st), jformats.stencil5_to_ell(ref))
    _same(formats.csr_to_stencil5(csr), jformats.csr_to_stencil5(jformats.stencil5_to_csr(ref)))
    if ref.constant is not None:
        _same(formats._stencil5_const_to_ell(ref.grid_size, *ref.constant),
              jformats._stencil5_const_to_ell(ref.grid_size, *ref.constant))


@pytest.mark.parametrize("name", list(CSRS))
def test_csr_conversions_match(name):
    ref = CSRS[name]()
    csr = carry(ref)
    _same(csr, ref)
    np.testing.assert_array_equal(csr.to_dense(), ref.to_dense())
    _same(formats.csr_to_ell(csr), jformats.csr_to_ell(ref))
    _same(formats.csr_to_dia(csr, max_diags=64), jformats.csr_to_dia(ref, max_diags=64))
    row = np.repeat(np.arange(ref.num_rows, dtype=np.int64), np.diff(ref.row_ptr))
    perm = np.random.RandomState(0).permutation(row.size)  # unsorted, as a file gives them
    coo = formats.COOMatrix(ref.num_rows, ref.num_cols, row[perm], ref.col_idx[perm],
                            ref.val[perm], ref.grid_size)
    _same(formats.coo_to_csr(coo), jformats.coo_to_csr(jformats.COOMatrix(
        ref.num_rows, ref.num_cols, row[perm], ref.col_idx[perm], ref.val[perm],
        ref.grid_size)))
    if name == "stencil_16":
        _same(formats.csr_to_stencil5(csr), jformats.csr_to_stencil5(ref))
    else:
        with pytest.raises(ValueError):
            formats.csr_to_stencil5(csr)


@pytest.mark.parametrize("name", list(CSRS))
def test_csr_to_coo_matches(name):
    """Every field equal to the JAX package's, and no array shared with the CSR."""
    ref = CSRS[name]()
    csr = carry(ref)
    coo = formats.csr_to_coo(csr)
    _same(coo, jformats.csr_to_coo(ref))
    for got in (coo.row, coo.col, coo.val):
        for src in (csr.row_ptr, csr.col_idx, csr.val):
            assert not np.shares_memory(got, src)
    _same(formats.coo_to_csr(coo), csr)  # and back


def test_csr_to_coo_random_csr():
    rng = np.random.RandomState(13)
    n, m = 40, 25
    lens = rng.randint(0, 6, size=n)
    lens[[3, 17]] = 0  # empty rows
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    col = np.concatenate([np.sort(rng.choice(m, k, replace=False)) for k in lens]
                         ).astype(np.int64)
    val = rng.randn(int(row_ptr[-1]))
    ref = jformats.CSRMatrix(num_rows=n, num_cols=m, row_ptr=row_ptr, col_idx=col, val=val)
    csr = carry(ref)
    coo = formats.csr_to_coo(csr)
    _same(coo, jformats.csr_to_coo(ref))
    for got in (coo.row, coo.col, coo.val):
        for src in (csr.row_ptr, csr.col_idx, csr.val, ref.col_idx, ref.val):
            assert not np.shares_memory(got, src)


def test_carry_checks_its_input():
    with pytest.raises(ValueError, match="inconsistent CSR"):
        convert.csr_from_numpy(3, 3, [0, 1, 2], [0, 1], [1.0, 1.0])
    with pytest.raises(ValueError, match="planes of shape"):
        convert.stencil5_from_numpy(4, np.zeros((5, 4, 3)))
    with pytest.raises(ValueError, match="planes or constant"):
        convert.stencil5_from_numpy(4)
    planes = jgenerate.make_stencil5(4).planes
    st = convert.stencil5_from_numpy(4, planes)
    assert not np.shares_memory(st.planes, planes) and st.constant is None
    with pytest.raises(TypeError):
        carry(jformats.stencil5_to_ell(jgenerate.make_stencil5(4)))


def _write_mtx(path, symmetric):
    """A small .mtx, general or symmetric (lower triangle), with a grid-size comment."""
    kind = "symmetric" if symmetric else "general"
    rows = [(1, 1, 4.0), (2, 1, -1.5), (3, 2, 0.25), (3, 3, 2.0), (4, 1, 1e-3), (4, 4, 7.0)]
    if not symmetric:
        rows += [(1, 4, -2.0), (2, 3, 0.5)]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {kind}\n% STENCIL_GRID_SIZE 2\n")
        f.write(f"% a comment\n4 4 {len(rows)}\n")
        f.writelines(f"{r} {c} {v!r}\n" for r, c, v in rows)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("reader", ["native", "numpy", "native after a failed load"])
def test_mtx_reader_matches(tmp_path, tmp_path_factory, monkeypatch, symmetric, reader):
    path = str(tmp_path / "m.mtx")
    _write_mtx(path, symmetric)
    if reader == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        _native_case(tmp_path_factory, monkeypatch, reader)
    assert io_mtx.read_matrix_type(path) == jio_mtx.read_matrix_type(path)
    coo, ref = io_mtx.load_matrix_market(path), jio_mtx.load_matrix_market(path)
    _same(coo, ref)
    assert coo.grid_size == 2 and coo.nnz == (9 if symmetric else 8)
    _same(formats.coo_to_csr(coo), jformats.coo_to_csr(ref))


def test_mtx_round_trip_and_refusals(tmp_path):
    coo = io_mtx.load_matrix_market(_mtx(tmp_path, 9))
    out = tmp_path / "back.mtx"
    io_mtx.write_matrix_market(str(out), coo)
    ref = tmp_path / "back_ref.mtx"
    jio_mtx.write_matrix_market(str(ref), jio_mtx.load_matrix_market(_mtx(tmp_path, 9)))
    assert out.read_bytes() == ref.read_bytes()
    bad = tmp_path / "complex.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n")
    with pytest.raises(ValueError, match="field type"):
        io_mtx.load_matrix_market(str(bad))


def _mtx(tmp_path, g):
    path = tmp_path / f"g{g}.mtx"
    if not path.exists():
        jgenerate.write_matrix_market_stencil5(str(path), g)
    return str(path)


@pytest.mark.parametrize("writer", ["native", "python", "native after a failed load"])
@pytest.mark.parametrize("g,diag,offdiag", [(1, 5.0, -1.0), (7, 5.0, -1.0), (16, 4.0, -0.3)])
def test_stencil_writer_byte_for_byte(tmp_path, tmp_path_factory, monkeypatch, writer, g,
                                      diag, offdiag):
    if writer == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        _native_case(tmp_path_factory, monkeypatch, writer)
        assert jnative.available() and native.available()
    port, ref = tmp_path / "port.mtx", tmp_path / "ref.mtx"
    nnz = generate.write_matrix_market_stencil5(str(port), g, diag, offdiag)
    assert nnz == jgenerate.write_matrix_market_stencil5(str(ref), g, diag, offdiag)
    assert nnz == generate.stencil5_nnz(g) == jgenerate.stencil5_nnz(g)
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("g", [1, 2, 3, 16, 20480])
def test_checksums_and_make_stencil5_match(g):
    assert generate.stencil5_spmv_checksums(g) == jgenerate.stencil5_spmv_checksums(g)
    assert generate.stencil5_spmv_checksums(g, 4.0, -0.3) == \
        jgenerate.stencil5_spmv_checksums(g, 4.0, -0.3)
    if g <= 16:
        _same(generate.make_stencil5(g, 4.0, -0.3), jgenerate.make_stencil5(g, 4.0, -0.3))
        _same(generate.make_stencil5(g, dtype=np.float32),
              jgenerate.make_stencil5(g, dtype=np.float32))


def test_stats_match():
    times = [3.1, 2.9, 3.0, 3.05, 9.7, 2.95, 3.02, 3.0, 2.98, 3.01]
    got, want = stats.compute_stats(times), jstats.compute_stats(times)
    assert vars(got) == vars(want)
    with pytest.raises(ValueError):
        stats.compute_stats([1.0, 2.0])
    with pytest.raises(ValueError):
        jstats.compute_stats([1.0, 2.0])


class _Op:
    num_rows = num_cols = 256
    nnz = 5 * 256 - 4 * 16
    grid_size = 16


class _CGStats:
    converged, iterations, residual_norm, relative_residual = True, 14, 1e-7, 6e-9
    total_time_ms, spmv_time_ms, blas1_time_ms, reduction_time_ms = 12.5, 7.0, 4.0, 1.5


def _without_timestamp(d):
    d = dict(d)
    assert d.pop("timestamp")
    return d


def test_export_dicts_match(tmp_path):
    bench = stats.compute_stats([2.0, 2.1, 1.9, 2.05])
    sysinfo = {"device_kind": "cpu"}
    m = metrics.SpmvMetrics(time_ms=0.5, gflops=1.25, bandwidth_gbs=3.5,
                            arithmetic_intensity=0.25, roofline_fraction=None,
                            bound="unknown (no peak)", bytes_moved=1024, nnz=_Op.nnz,
                            rows=_Op.num_rows, dtype="f32", timing_flags=("a_flag",))
    jm = jmetrics.SpmvMetrics(**vars(m))
    kw = dict(mode="stencil5", matrix_name="g16", op=_Op, sysinfo=sysinfo, sum_y=1.0,
              norm2_y=2.0, kernel_ms=0.4, run_protocol="device-resident")
    spmv = export.spmv_result_dict(metrics=m, stats=bench, **kw)
    assert _without_timestamp(spmv) == _without_timestamp(jexport.spmv_result_dict(
        metrics=jm, stats=jstats.compute_stats([2.0, 2.1, 1.9, 2.05]), **kw))
    kw = dict(solver="s", mode="stencil5-const", matrix_name="g16", op=_Op,
              cg_stats=_CGStats, sysinfo=sysinfo, sum_x=3.0, norm2_x=4.0, gflops_spmv=9.0,
              extra_timing={"x_ms": 1.0}, loop="recompute-ap")
    cg = export.cg_result_dict(bench_stats=bench, **kw)
    assert _without_timestamp(cg) == _without_timestamp(jexport.cg_result_dict(
        bench_stats=jstats.compute_stats([2.0, 2.1, 1.9, 2.05]), **kw))
    for mod, name in ((export, "port"), (jexport, "ref")):
        mod.write_json(str(tmp_path / f"{name}.json"), {**cg, "timestamp": "t"})
        mod.append_csv(str(tmp_path / f"{name}.csv"), {**cg, "timestamp": "t"})
        mod.append_csv(str(tmp_path / f"{name}.csv"), {**cg, "timestamp": "t"})
    for ext in ("json", "csv"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_byte_models_match(itemsize):
    for rows, nnz, width, ndiag in ((400, 1920, 5, 5), (20480 ** 2, 5 * 20480 ** 2, 5, 5),
                                    (1000, 9000, 17, 9)):
        assert metrics.spmv_flops(nnz) == jmetrics.spmv_flops(nnz)
        for idx in (4, 8):
            assert metrics.bytes_csr(nnz, rows, itemsize, idx) == \
                jmetrics.bytes_csr(nnz, rows, itemsize, idx)
            assert metrics.bytes_ell(rows, width, itemsize, idx) == \
                jmetrics.bytes_ell(rows, width, itemsize, idx)
        assert metrics.bytes_stencil5(rows, itemsize) == jmetrics.bytes_stencil5(rows, itemsize)
        assert metrics.bytes_stencil5_const(rows, itemsize) == \
            jmetrics.bytes_stencil5_const(rows, itemsize)
        assert metrics.bytes_dia(rows, ndiag, itemsize) == \
            jmetrics.bytes_dia(rows, ndiag, itemsize)
        assert metrics.cg_gflops(nnz, 14, 3.5) == jmetrics.cg_gflops(nnz, 14, 3.5)

    class Op:
        num_rows = 4096

    for mode in ("stencil5", "stencil5-bf16c", "stencil5-const"):
        assert metrics.BYTE_MODELS[mode](Op, itemsize) == \
            jmetrics.BYTE_MODELS[mode](Op, itemsize)

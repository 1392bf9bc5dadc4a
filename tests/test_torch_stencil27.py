"""HPCG's 27-point problem in the port, on the CPU.

- ``formats.Stencil27`` and ``stencil27_to_csr`` against HPCG's definition
  (src/GenerateProblem_ref.cpp) written out as a dense matrix, loop by loop;
- ``generate.make_stencil27_ell_device``: its y equals the ELL twin's over the host pack
  ``formats.csr_to_ell(stencil27_to_csr(st))`` bit for bit, and it refuses what it cannot
  build;
- the ELL modes take a ``Stencil27`` through ``ops.get_operator``, every other mode refuses
  it; CG on it equals the benchmark's plain reference (``cgbench/problems/hpcg27.py``'s
  ``apply`` with ``cgbench/reference/cg.py``'s ``solve``), at HPCG's fixed 50 iterations
  (tolerance 0, which converges once it has run them all) and at tol 1e-6, and a diagonal
  off by 1e-3 fails that comparison;
- the ``Stencil27_Build`` span inside ``Operator_Build``, and the ELL kernel's launch
  count by width, which a capture sets apart like every count.

The CUDA kernel at width 27 is held to its twin on a card in tests/test_torch_cuda.py.
"""

import functools
import json
import types

import numpy as np
import pytest
import torch

from cgbench import check, spec
from cgbench.reference import cg as reference
from tpusparse_torch import convert, formats, generate, ops
from tpusparse_torch.bench import profiling
from tpusparse_torch.formats import Stencil27
from tpusparse_torch.kernels import _launch, ell
from tpusparse_torch.solvers import cg

CONFIG = json.loads(spec.config_path("hpcg27-512-f64").read_text())
HPCG27 = spec.problem("hpcg27")


def _hpcg_dense(nx, ny, nz, diag=26.0, offdiag=-1.0):
    """HPCG's matrix as GenerateProblem_ref.cpp writes it: for each point (ix, iy, iz),
    row iz·nx·ny + iy·nx + ix, a loop over sz, sy, sx in {−1, 0, 1} keeping the neighbours
    on the grid."""
    n = nx * ny * nz
    a = np.zeros((n, n))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = iz * nx * ny + iy * nx + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            jz, jy, jx = iz + sz, iy + sy, ix + sx
                            if 0 <= jz < nz and 0 <= jy < ny and 0 <= jx < nx:
                                col = jz * nx * ny + jy * nx + jx
                                a[row, col] = diag if col == row else offdiag
    return a


@pytest.mark.parametrize("shape", [(4, 4, 4), (3, 4, 5)])
def test_stencil27_csr_is_hpcgs_matrix(shape):
    st = Stencil27(*shape)
    csr = formats.stencil27_to_csr(st)
    dense = csr.to_dense()
    np.testing.assert_array_equal(dense, _hpcg_dense(*shape))
    np.testing.assert_array_equal(dense, dense.T)
    np.testing.assert_array_equal(np.diag(dense), 26.0)
    assert csr.num_rows == st.num_rows and csr.nnz == st.nnz
    assert all(np.all(np.diff(csr.col_idx[a:b]) > 0)
               for a, b in zip(csr.row_ptr[:-1], csr.row_ptr[1:]))
    # interior rows 27 entries, faces 18, edges 12, corners 8
    lens = np.diff(csr.row_ptr)
    inner = np.prod([n - 2 for n in shape])
    faces = sum(2 * np.prod([m - 2 for j, m in enumerate(shape) if j != i])
                for i in range(3))
    edges = sum(4 * (n - 2) for n in shape)
    assert dict(zip(*np.unique(lens, return_counts=True))) == {8: 8, 12: edges, 18: faces,
                                                                27: inner}


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 3), (1, 5, 1), (7, 2, 4), (9, 9, 9)])
def test_stencil27_nnz_counts_every_stored_entry(shape):
    st = Stencil27(*shape)
    assert st.nnz == formats.stencil27_to_csr(st).nnz
    assert st.num_rows == int(np.prod(shape))


@pytest.mark.parametrize("shape", [(5, 5, 5), (4, 6, 3), (1, 1, 1), (2, 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generated_operand_equals_the_host_pack_through_the_twin(shape, dtype):
    """Slot k of the device operand is offset k in HPCG's order, an off-grid neighbour a
    zero at the point itself; the host pack packs each row's entries left.  Both orders
    keep a row's real entries in order, so the twin's y is the same bit for bit."""
    st = Stencil27(*shape)
    n = st.num_rows
    vals, cols = generate.make_stencil27_ell_device(*shape, dtype=dtype, device="cpu")
    assert vals.shape == cols.shape == (27, n)
    assert vals.dtype == dtype and cols.dtype == torch.int32
    assert int(cols.min()) >= 0 and int(cols.max()) < n
    assert int(torch.count_nonzero(vals)) == st.nnz
    assert torch.equal(cols[formats.STENCIL27_CENTER], torch.arange(n, dtype=torch.int32))
    host = formats.csr_to_ell(formats.stencil27_to_csr(st))
    hvals, hcols = convert.ell_from_numpy(host.col, host.val, dtype, "cpu")
    gen = torch.Generator().manual_seed(27)
    for _ in range(3):
        x = torch.randn(n, generator=gen, dtype=dtype)
        assert torch.equal(ell.spmv_ell_plain(vals, cols, x),
                           ell.spmv_ell_plain(hvals, hcols, x))
    dense = torch.from_numpy(_hpcg_dense(*shape)).to(dtype)
    torch.testing.assert_close(ell.spmv_ell_plain(vals, cols, x), dense @ x)


def test_generator_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="int32"):
        generate.make_stencil27_ell_device(1291, 1291, 1291, device="cpu")  # 2.15e9 points
    with pytest.raises(ValueError, match=">= 1"):
        generate.make_stencil27_ell_device(4, 0, 4, device="cpu")


@pytest.mark.parametrize("mode", sorted(set(ops.available_modes()) - set(ops.STENCIL27_MODES)))
def test_other_modes_refuse_the_27_point_stencil(mode):
    with pytest.raises(ValueError, match="'csr'"):
        ops.get_operator(mode, Stencil27(4, 4, 4), torch.float64, "cpu")


@pytest.mark.parametrize("mode", ops.STENCIL27_MODES)
def test_ell_modes_take_it_as_a_generic_operator(mode):
    st = Stencil27(4, 3, 5)
    op = ops.get_operator(mode, st, torch.float64, "cpu")
    assert (op.num_rows, op.nnz, op.grid_size, op.field_shape) == (60, st.nnz, 0, (60,))
    vals, cols = generate.make_stencil27_ell_device(4, 3, 5, dtype=torch.float64,
                                                    device="cpu")
    assert torch.equal(op.operand["vals"], vals) and torch.equal(op.operand["cols"], cols)


def _x_err(op_diag, tol, max_iters, g=8, seed=2 ** 33 + 27):
    """(x_err, iterations, the reference's iterations) of CG on the csr-xla operator of
    Stencil27(g, g, g, (op_diag, −1)) against the plain reference on the configuration's
    matrix, one seeded b."""
    c = {**CONFIG, "tolerance": tol, "max_iters": max_iters}
    b = torch.randn(HPCG27.shape(c, g), generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    op = ops.get_operator("csr-xla", Stencil27(g, g, g, (op_diag, c["offdiag"])),
                          torch.float64, "cpu")
    x, stats = cg.cg_solve(op, b.reshape(-1), config=cg.CGConfig(max_iters=max_iters,
                                                                 tolerance=tol))
    assert stats.converged
    x_ref, k_ref = reference.solve(b, functools.partial(HPCG27.apply, config=c), tol,
                                   max_iters)
    return check.field_gap(x, x_ref) / check.scale(x_ref), stats.iterations, k_ref


@pytest.mark.parametrize("tol,max_iters", [(0.0, 50), (1e-6, 1000)],
                         ids=["hpcg-set-50", "tol-1e-6"])
def test_cg_on_the_operator_equals_the_plain_reference(tol, max_iters):
    assert HPCG27.operand(CONFIG, 8) == Stencil27(8, 8, 8, (26.0, -1.0))
    x_err, k, k_ref = _x_err(CONFIG["diag"], tol, max_iters)
    assert k == k_ref and (tol > 0 or k == 50)
    assert x_err <= 1e-13


def test_a_diagonal_off_by_1e_3_fails_the_comparison():
    x_err, k, k_ref = _x_err(CONFIG["diag"] + 1e-3, 0.0, 50)
    assert k == k_ref == 50
    assert x_err > CONFIG["limits"]["x_err"]


def test_hpcg27_apply_is_the_dense_matrix_and_writes_into_out():
    c = {**CONFIG, "nx": 5, "ny": 4, "nz": 3}
    assert HPCG27.shape(c) == (3, 4, 5) and HPCG27.shape(c, 6) == (6, 6, 6)
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    out = torch.full_like(x, float("nan"))
    y = HPCG27.apply(x, c, out=out)
    assert y is out
    torch.testing.assert_close(y.reshape(-1), torch.from_numpy(_hpcg_dense(5, 4, 3)) @
                               x.reshape(-1), rtol=1e-14, atol=1e-13)
    assert torch.equal(HPCG27.apply(x, c), y)


@pytest.mark.parametrize("stepped", [False, True], ids=["cg_solve", "stepped"])
def test_tolerance_zero_runs_every_iteration_and_converges(stepped):
    """Tolerance 0 asks for a fixed count (HPCG's CG sets): the solve runs all max_iters
    iterations, or stops on an exactly zero residual, and reports it converged; a
    positive tolerance keeps its test."""
    op = ops.get_operator("csr-xla", Stencil27(6, 6, 6), torch.float64, "cpu")
    b = op.ones_b()
    for tol, iters, want in ((0.0, 7, True), (1e-30, 7, False)):
        config = cg.CGConfig(max_iters=iters, tolerance=tol)
        if stepped:
            _, s = cg.cg_solve_stepped(op.run_device_dot, b, config=config)
        else:
            _, s = cg.cg_solve(op, b, config=config)
        assert s.iterations == iters and s.converged is want
    # one point: x = 1/26 leaves r exactly 0 after one step, which ends every loop
    one = ops.get_operator("csr-xla", Stencil27(1, 1, 1), torch.float64, "cpu")
    config = cg.CGConfig(max_iters=7, tolerance=0.0)
    if stepped:
        x, s = cg.cg_solve_stepped(one.run_device_dot, one.ones_b(), config=config)
    else:
        x, s = cg.cg_solve(one, one.ones_b(), config=config)
    assert s.iterations == 1 and s.residual_norm == 0 and s.converged is True
    assert x.tolist() == [1 / 26]
    assert cg.converged(0.0, 1.0, 0.0, 1, 7) is True
    assert cg.converged(float("nan"), 1.0, 0.0, 7, 7) is False
    assert cg.converged(1.0, 1.0, 0.0, 6, 7) is False
    assert cg.converged(0.0, 0.0, 0.0, 0, 7) is True  # b = 0


def test_stencil27_build_span_inside_operator_build():
    st = Stencil27(5, 4, 3)
    profiling.reset()
    with profiling.recording():
        ops.get_operator("csr-xla", st, torch.float32, "cpu")
    spans = profiling.spans()
    profiling.reset()
    assert [sp.name for sp in spans] == [profiling.PHASE_OPERATOR_BUILD,
                                         profiling.PHASE_STENCIL27_BUILD]
    build = spans[1]
    assert build.parent == 0 and build.end_ns >= build.start_ns
    assert build.attrs == {"nx": 5, "ny": 4, "nz": 3, "width": 27, "slots": 27 * 60,
                           "bytes": 27 * 60 * (4 + 4)}
    assert profiling.PHASE_STENCIL27_BUILD in profiling.NAMES


def test_kernel_launches_count_by_width(monkeypatch):
    """The launch path of ``spmv_ell`` (on meta tensors, the library faked: the kernel has
    no CPU mode) counts each launch under ``spmv_ell`` and under its width."""
    calls = []
    lib = types.SimpleNamespace(tps_spmv_ell_f64=lambda *a: calls.append(a[4:6]) or 0)
    monkeypatch.setattr(ell, "_build", types.SimpleNamespace(lib=lambda: lib,
                                                             check=lambda rc, name: None))
    monkeypatch.setattr(ell, "check_field", lambda t, like: t.numel())
    monkeypatch.setattr(ell, "stream", lambda t: 0)
    ell.reset_launches()
    x = torch.empty(64, dtype=torch.float64, device="meta")
    for width, times in ((27, 3), (5, 1)):
        vals = torch.empty((width, 64), dtype=torch.float64, device="meta")
        cols = torch.empty((width, 64), dtype=torch.int32, device="meta")
        for _ in range(times):
            ell.spmv_ell(vals, cols, x)
    assert calls == [(27, 64)] * 3 + [(5, 64)]
    assert ell.LAUNCHES == {"spmv_ell": 4, "spmv_ell_w27": 3, "spmv_ell_w5": 1}
    with _launch.set_apart() as launches:  # a capture: the new width counted, taken out
        ell.spmv_ell(torch.empty((9, 64), dtype=torch.float64, device="meta"),
                     torch.empty((9, 64), dtype=torch.int32, device="meta"), x)
    assert launches == {"spmv_ell": 1, "spmv_ell_w9": 1}
    assert ell.LAUNCHES == {"spmv_ell": 4, "spmv_ell_w27": 3, "spmv_ell_w5": 1}
    ell.reset_launches()
    assert ell.LAUNCHES == {"spmv_ell": 0}
